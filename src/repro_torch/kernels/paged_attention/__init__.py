"""Paged-window GQA attention: CUDA kernel, binding, plain version."""
