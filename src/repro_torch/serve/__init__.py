"""Serving engine, block pool, sampling, telemetry."""
