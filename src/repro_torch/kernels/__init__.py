"""Hand-written Hopper kernels, each beside its plain PyTorch version.

One predicate, :func:`kernel_route`, sends a call to a kernel: CUDA
tensors launch it, meta tensors (the dry-run's, ``launch/dryrun.py``)
call its op, and CPU tensors take its plain version. Every launch is a
``torch.library`` op (:func:`kernel_op`) whose CUDA implementation is the
``ctypes`` launch, whose fake (meta) implementation gives its outputs'
shapes, and whose cost (``costs.py``) is its FLOP formula for
``torch.utils.flop_counter`` and its FLOPs and bytes for
``launch/step_analysis.py``, which sees a launch as one op of its real
shapes.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.flop_counter import register_flop_formula


def kernel_route(t) -> bool:
    """Whether a call on ``t`` takes the hand-written kernel: on CUDA and
    meta tensors it does; on the CPU the plain PyTorch version runs."""
    return t.device.type in ("cuda", "meta")


_LAUNCH_LOCK = threading.Lock()


def count_launch(fn) -> None:
    """Add one to ``fn.launches``, the launch count of a kernel wrapper,
    under a lock: exact when several threads launch at once (a bare
    ``+=`` on an attribute can lose a count between its read and its
    write)."""
    with _LAUNCH_LOCK:
        fn.launches += 1


# the op's overload packet -> its cost function over the op's arguments
COSTS: dict = {}


# the library that owns the kernels' ops (kept alive with this module)
_LIB = torch.library.Library("repro_torch", "DEF")


def kernel_op(name: str, schema: str, launch, fake, cost):
    """Define the op ``repro_torch::<name>(schema)`` with ``launch`` (the
    ctypes launch) as its CUDA implementation, ``fake`` as its meta one,
    and ``cost`` ((flops, bytes) from the op's arguments) as its FLOP
    formula. Returns the op, which a wrapper calls with the op's
    arguments. The op is defined through ``Library.define`` /
    ``impl``, not ``torch.library.custom_op``, whose Python wrapper
    adds host time to every launch; ``scripts/torch_plan_moe_cost.py``
    times an op against the launch it wraps."""
    _LIB.define(name + schema)
    _LIB.impl(name, launch, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    packet = getattr(torch.ops.repro_torch, name)
    op = packet.default
    COSTS[packet] = cost

    @register_flop_formula(packet, get_raw=True)
    def _flops(*args, out_val=None, **kwargs):
        return cost(*args, **kwargs)[0]

    return op


def check_device(name: str, t) -> None:
    """A kernel takes CUDA tensors, and meta ones for its op's shapes."""
    if not kernel_route(t):
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{t.device}")


def refuse_grad(op: str, *tensors) -> None:
    """Raise if autograd would record a call of ``op``, a CUDA kernel
    without a backward of its own: its output would carry no gradient to
    its inputs, so a loss through it would train nothing below it without
    an error. The paged-window and stripe-decode kernels serve only; the
    flash, WKV and selective-scan kernels train through the autograd
    functions of their ops, never by a direct kernel call. Serving runs
    under ``torch.no_grad()`` and never trips this."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: this CUDA kernel call has no backward, and an input "
            f"requires grad. The paged-window and stripe-decode kernels "
            f"serve only; the flash, WKV and selective-scan kernels train "
            f"through their ops (kernels/*/ops.py). Call it under "
            f"torch.no_grad(), or detach the inputs")


# (owner, device, stream) -> the scratch tensors of ``stream_scratch``
_SCRATCH: dict = {}


def stream_scratch(owner: str, device, stream, specs):
    """Scratch tensors of a kernel for its calls on one CUDA stream: one
    per (numel, dtype, zeroed) of ``specs``, cached per (owner, device,
    stream) and grown (all re-made) when a call needs more. A zeroed one
    holds counters that start at 0 and that the kernel leaves at 0; the
    calls of one stream run in order, so one allocation serves them all."""
    key = (owner, device, stream)
    have = _SCRATCH.get(key)
    if have is None or any(t.numel() < n for t, (n, _, _) in
                           zip(have, specs)):
        have = tuple(
            (torch.zeros if zeroed else torch.empty)(
                max(n, 1, 0 if have is None else have[i].numel()),
                dtype=dtype, device=device)
            for i, (n, dtype, zeroed) in enumerate(specs))
        _SCRATCH[key] = have
    return have
