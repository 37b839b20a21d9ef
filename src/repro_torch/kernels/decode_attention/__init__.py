"""Single-token GQA decode attention with (out, lse): CUDA kernel,
binding, plain version, and the sequence-sharded merge."""
