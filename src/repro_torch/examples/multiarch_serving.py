"""The paper's architecture x the model zoo: several *different
architectures* deployed as parallel Prediction-as-a-Service endpoints on
one device.

    PYTHONPATH=src python -m repro_torch.examples.multiarch_serving \
        [--archs qwen3-4b,rwkv6-1.6b,hymba-1.5b] [--requests 4] \
        [--max-new 4] [--device cuda|cpu]

Each architecture (reduced config, f32) becomes one PaaS: a ServingEngine
+ Scheduler behind a Service, started in supervisor priority order. A
router fans each request out to the services in parallel on a thread
dispatcher (the paper's Fig 5 with NER sections replaced by LM
architectures), so on the card the engines launch their kernels from
several threads at once; the joined result reports per-service latency
and generated tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core.parallel import ParallelDispatcher
from repro_torch.core.services import Replica, Service
from repro_torch.core.supervisor import Supervisor
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import Scheduler


class LMPaaS:
    """One architecture as a Prediction-as-a-Service endpoint. ``cfg``
    defaults to the reduced config in f32, ``params`` to random weights
    from ``seed``."""

    def __init__(self, arch: str, seed: int, *, batch=2, max_seq=64,
                 device="cuda", cfg=None, params=None):
        self.arch = arch
        if cfg is None:
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype=torch.float32)
        self.cfg = cfg
        model = build_model(cfg, device=device)
        if params is None:
            params = model.init(seed)
        self.scheduler = Scheduler(ServingEngine(
            model, params, batch_size=batch, max_seq=max_seq,
            use_kernel=True, device=device))
        self._rid = 0

    def __call__(self, payload):
        prompt, max_new = payload
        self._rid += 1
        req = Request(rid=self._rid, prompt=list(prompt),
                      max_new_tokens=max_new)
        assert self.scheduler.submit(req)
        done = self.scheduler.drain()
        (r,) = [d for d in done if d.rid == req.rid]
        return {"arch": self.arch, "tokens": r.out_tokens,
                "latency_s": r.latency_s}


def deploy_router(paases: list):
    """Each ``LMPaaS`` behind a one-replica Service, then the router that
    fans a payload out to all of them on a thread dispatcher, under a
    Supervisor. Returns (supervisor, router service, dispatcher,
    startup order)."""
    sup = Supervisor()
    services = {}
    for paas in paases:
        svc = Service(paas.arch, replicas=[Replica(f"{paas.arch}/0", paas)],
                      priority=2)
        services[paas.arch] = sup.add(svc)
    dispatcher = ParallelDispatcher(mode="thread", max_workers=len(paases))

    def parse(payload):
        return dispatcher([(a, svc, payload) for a, svc in services.items()])

    sup.add(Service("router", replicas=[Replica("router/0", parse)],
                    priority=3, depends_on=tuple(services)))
    order = sup.start_all()
    return sup, sup.services["router"], dispatcher, order


def prompts(n: int, device) -> list:
    """``n`` prompts of 8 tokens in [2, 500), from a ``torch.Generator``
    on ``device`` seeded 99."""
    gen = torch.Generator(device=device).manual_seed(99)
    return [torch.randint(2, 500, (8,), generator=gen, device=device)
            .tolist() for _ in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen3-4b,rwkv6-1.6b,hymba-1.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    archs = [a.strip() for a in args.archs.split(",")]
    assert all(a in ARCH_IDS for a in archs), archs

    # priority-ordered deployment: services first, front-end router last
    paases = []
    for i, arch in enumerate(archs):
        print(f"loading {arch} ...", flush=True)
        paases.append(LMPaaS(arch, seed=i, device=args.device))
    sup, router, dispatcher, order = deploy_router(paases)
    print("startup order:", " -> ".join(order))

    lat = []
    for i, prompt in enumerate(prompts(args.requests, args.device)):
        t0 = time.perf_counter()
        res = router((prompt, args.max_new))
        lat.append(time.perf_counter() - t0)
        if i == 0:
            for a in archs:
                out = res.outputs[a]
                print(f"  {a:14s} ({get_config(a).family:6s}) "
                      f"-> {out['tokens']} "
                      f"({res.per_call_s[a]*1e3:.0f} ms)")
            print(f"  parallel={res.total_s*1e3:.0f} ms vs sequential-"
                  f"equivalent={res.sequential_equivalent_s*1e3:.0f} ms")
    dispatcher.shutdown()
    print(f"\n{args.requests} requests x {len(archs)} architectures; "
          f"median join latency {statistics.median(lat)*1e3:.0f} ms")
    print("OK")


if __name__ == "__main__":
    main()
