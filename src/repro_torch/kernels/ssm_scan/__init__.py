"""Mamba selective scan: CUDA kernel, binding, plain version."""
