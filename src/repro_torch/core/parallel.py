"""Parallel vs sequential multi-service dispatch (paper §3.2.4 / §4.2;
own copy of the reference's ``core/parallel.py``).

The paper forks a ``multiprocessing.Process`` per section and joins the
results; its claim (Fig 8) is that parallel dispatch cuts the service
phase from 1.792 s to 0.568 s median (>3x). Here a dispatch is a list of
(service, payload) calls executed by one of three executors:

* ``sequential``   — the paper's monolithic baseline (one after another)
* ``thread``       — pool fan-out; overlaps the waiting on replicas, which
                     is the paper's situation (its PaaS are remote machines)
* ``device_async`` — for in-process PyTorch services: enqueue every call's
                     device work before waiting on any result, then wait on
                     each output in call order (the reference's
                     ``jax_async``: CUDA launches return before the card
                     finishes, as JAX's dispatch does)

Process-per-request is deliberately NOT used: one runtime owns the card.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import torch


@dataclass
class DispatchResult:
    outputs: dict                      # call name -> output
    per_call_s: dict                   # call name -> service wall time
    total_s: float
    mode: str

    @property
    def sequential_equivalent_s(self) -> float:
        """Sum of per-call times = what a monolithic pipeline would pay."""
        return sum(self.per_call_s.values())

    @property
    def speedup(self) -> float:
        return self.sequential_equivalent_s / max(self.total_s, 1e-9)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree):
    """Wait for the CUDA devices that hold a tensor of ``tree`` (a tensor
    or a dict / list / tuple of them); return ``tree``. The counterpart
    of ``jax.block_until_ready``: CPU tensors and other leaves are ready."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


@dataclass
class ParallelDispatcher:
    mode: str = "thread"               # thread | sequential | device_async
    max_workers: int = 8
    rng: object = None                 # random.Random for latency models
    _pool: ThreadPoolExecutor = field(default=None, repr=False)

    def __post_init__(self):
        if self.mode == "thread":
            self._pool = ThreadPoolExecutor(max_workers=self.max_workers)

    def __call__(self, calls: list) -> DispatchResult:
        """calls: list of (name, service, payload)."""
        t0 = time.perf_counter()
        outputs: dict = {}
        timings: dict = {}

        def run_one(name, svc, payload):
            s = time.perf_counter()
            out = svc(payload, self.rng)
            timings[name] = time.perf_counter() - s
            return name, out

        if self.mode == "sequential":
            for name, svc, payload in calls:
                outputs[name] = run_one(name, svc, payload)[1]
        elif self.mode == "thread":
            futs = [self._pool.submit(run_one, *c) for c in calls]
            for f in futs:
                name, out = f.result()
                outputs[name] = out
        elif self.mode == "device_async":
            # enqueue everything (launches return at once), then wait in
            # order
            pending = []
            for name, svc, payload in calls:
                s = time.perf_counter()
                out = svc(payload, self.rng)       # un-synchronised tensors
                pending.append((name, out, s))
            for name, out, s in pending:
                outputs[name] = block_until_ready(out)
                timings[name] = time.perf_counter() - s
        else:
            raise ValueError(f"unknown dispatch mode {self.mode}")
        return DispatchResult(outputs, timings, time.perf_counter() - t0,
                              self.mode)

    def shutdown(self):
        if self._pool:
            self._pool.shutdown()
