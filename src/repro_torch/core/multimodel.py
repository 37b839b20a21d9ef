"""Device space-sharing: the paper's parallel PaaS (port of the
reference's ``core/multimodel.py``).

The paper gives every section-NER its own machines; the analogue here is
giving every model service a disjoint group of devices. Because CUDA
launches return before the device finishes, enqueueing all services'
computations before waiting on any result runs them concurrently on
their disjoint devices — one host thread, K models in flight.

A service runs on its group's first device: the reference replicates its
params and batch over the group's sub-mesh, and a replicated computation
gives the same output on one device as on the group. With fewer devices
than services the groups overlap and space-sharing degenerates to
time-sharing; the dispatch / join logic is identical, which is what the
tests exercise. The reference's ``lower_all`` (XLA ahead-of-time
compile) has no PyTorch counterpart and is not ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.core.parallel import block_until_ready


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


@dataclass
class ModelService:
    name: str
    step_fn: callable              # (params, batch) -> output
    params: object
    devices: list = field(default_factory=list)   # its group

    @property
    def device(self) -> torch.device:
        return self.devices[0]


class MultiModelServer:
    """Partition a list of devices into per-service groups."""

    def __init__(self, services: list, devices=None):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("MultiModelServer: no CUDA device; pass "
                                   "devices= to serve elsewhere")
        devices = [torch.device(d) for d in devices]
        self.services: dict[str, ModelService] = {}
        for svc, devs in zip(services, self._partition(devices,
                                                       len(services))):
            svc.devices = devs
            svc.params = _to(svc.params, svc.device)
            self.services[svc.name] = svc
        self.stats = {"parallel_calls": 0, "sequential_calls": 0}

    @staticmethod
    def _partition(devices: list, k: int) -> list:
        n = len(devices)
        if n >= k:
            per = n // k
            return [devices[i * per:(i + 1) * per] for i in range(k)]
        # degenerate: overlap groups (time-sharing)
        return [[devices[i % n]] for i in range(k)]

    # ------------------------------------------------------------ serving
    def _run(self, name, batch):
        svc = self.services[name]
        return svc.step_fn(svc.params, _to(batch, svc.device))

    def serve_parallel(self, batches: dict) -> tuple[dict, float]:
        """Enqueue every service, then join (paper's parallel calling)."""
        t0 = time.perf_counter()
        pending = {name: self._run(name, b) for name, b in batches.items()}
        out = {n: block_until_ready(o) for n, o in pending.items()}
        self.stats["parallel_calls"] += 1
        return out, time.perf_counter() - t0

    def serve_sequential(self, batches: dict) -> tuple[dict, float]:
        """Wait after each service (paper's monolithic baseline)."""
        t0 = time.perf_counter()
        out = {name: block_until_ready(self._run(name, b))
               for name, b in batches.items()}
        self.stats["sequential_calls"] += 1
        return out, time.perf_counter() - t0
