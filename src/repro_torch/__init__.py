"""PyTorch / CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module paths and public names (``configs``, ``models``, ``kernels``,
``serve``) and imports neither ``jax`` nor anything of ``repro``.
Entry points take a ``device`` (default ``"cuda"``); the CPU is used
only when the caller asks for it.
"""
