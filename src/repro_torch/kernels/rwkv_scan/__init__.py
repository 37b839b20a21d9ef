"""RWKV-6 WKV recurrence: CUDA kernel, binding, plain version."""
