"""Blocked causal / sliding-window GQA attention: CUDA kernel, binding,
plain version."""
