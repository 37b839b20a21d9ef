"""Sharding rules of the port: ``ParallelPlan`` over a torch ``DeviceMesh``."""
