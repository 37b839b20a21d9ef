#!/usr/bin/env python3
"""What a decode plan costs on one card.

    python scripts/torch_plan_moe_cost.py [--calls 200] [--steps 30]
        [--profile]

On a 1 x 1 mesh of one NCCL rank, one layer of full-width grok-1-314b
(bf16, 8 experts, top-2) at a decode step of B 8: ``moe_ffn`` without a
plan (``moe_ffn_local``) against ``moe_ffn`` under a decode plan
(``moe_decode_ffn``: EP, E_loc 8, weight rows over ``data``), and one
all-reduce of a 0-d tensor on the ``model`` group. For each: the
collectives a call issues, the host's ms a call (``--calls`` calls
enqueued back to back, then one synchronise) and the device's ms a call
(CUDA events around the same loop). Then whole decode steps (B 8,
stripes of 1024, DTensor params under the plan) of full-width
grok-1-314b at 2 layers and qwen3-4b at 36, without and with the plan,
timed the same way over ``--steps`` steps: where the plan's serve loses
time, host or device. Then one stripe-decode launch at the qwen3-4b
step's shape through its ``torch.library`` op and through the direct
ctypes call the op wraps, ``TURNS`` times each in turns (op, direct,
direct, op, ...) over ``--calls`` x 10 calls: what the op's dispatch
costs the host a launch.
``--profile`` also prints the host functions that take most of the
planned qwen3-4b step (``cProfile``, by own time). Prints the card's
name and power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import io
import json
import pstats
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.rules import ParallelPlan  # noqa: E402


TURNS = 6


def timed(fn, calls: int) -> tuple:
    """(host ms a call, device ms a call) over ``calls`` enqueued calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    end.record()
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / calls


def decode_steps(arch, layers, mesh, counts, steps, profile) -> dict:
    """Host and device ms of a decode step (B 8 at 64 cached tokens) of
    ``arch`` cut to ``layers``, without and with a decode plan; with
    ``profile``, the planned step's top host functions are printed."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    plan = ParallelPlan.make(mesh, cfg, "decode")
    dparams = plan.param_shardings(params)
    cache = model.init_cache(8, 1024)
    tok = torch.ones((8, 1), dtype=torch.int32, device="cuda")
    n = torch.full((8,), 64, dtype=torch.int32, device="cuda")
    out = {}
    with torch.no_grad():
        for name, fn in (
                ("no_plan", lambda: model.decode_step(params, tok, cache, n)),
                ("plan", lambda: model.decode_step(dparams, tok, cache, n,
                                                   plan=plan))):
            counts.update(all_reduce=0, all_gather=0)
            fn()
            per_call = dict(counts)
            host, device = timed(fn, steps)
            out[name] = {"collectives_a_step": per_call, "host_ms": host,
                         "device_ms": device}
            if profile and name == "plan":
                prof = cProfile.Profile()
                prof.runcall(lambda: [fn() for _ in range(5)])
                torch.cuda.synchronize()
                text = io.StringIO()
                pstats.Stats(prof, stream=text).sort_stats(
                    "tottime").print_stats(30)
                print(f"{arch}, {layers} layers, 5 planned steps:\n"
                      + text.getvalue())
    del params, dparams, cache, model
    torch.cuda.empty_cache()
    return out


def op_dispatch_us(calls: int, turns: int) -> dict:
    """Host and device microseconds of one stripe-decode launch at
    qwen3-4b's decode shape (B 8, 32 / 8 heads of 128, a full 1024-slot
    stripe, bf16) through the kernel's op and through the direct ctypes
    launch it wraps, in turns: the medians and every turn."""
    from repro_torch.kernels.decode_attention import kernel as dec
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((8, 32, 128), generator=g, device="cuda").bfloat16()
    kv = torch.randn((8, 8, 1024, 128), generator=g,
                     device="cuda").bfloat16()
    n = torch.full((8,), 1024, dtype=torch.int32, device="cuda")
    routes = {"ops": lambda: dec._op(q, kv, kv, n, 0),
              "direct": lambda: dec._launch(q, kv, kv, n, 0)}
    runs = {"ops": [], "direct": []}
    with torch.no_grad():
        for t in range(turns):
            for route in (("ops", "direct") if t % 2 == 0
                          else ("direct", "ops")):
                host, device = timed(routes[route], calls)
                runs[route].append((host * 1e3, device * 1e3))
    return {route: {"host_us": statistics.median(h for h, _ in r),
                    "device_us": statistics.median(d for _, d in r),
                    "turns": r}
            for route, r in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    counts = {"all_reduce": 0, "all_gather": 0}
    real_reduce, real_gather = dist.all_reduce, rules._all_gather_single

    def reduce(*a, **k):
        counts["all_reduce"] += 1
        return real_reduce(*a, **k)

    def gather(*a, **k):
        counts["all_gather"] += 1
        return real_gather(*a, **k)

    rules.dist.all_reduce, rules._all_gather_single = reduce, gather
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh()
            cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=1)
            gen = torch.Generator(device="cuda").manual_seed(0)
            p = moe.init_moe(gen, cfg, "cuda")
            x = torch.randn((8, 1, cfg.d_model), generator=gen,
                            device="cuda").to(cfg.dtype)
            plan = ParallelPlan.make(mesh, cfg, "decode")
            zero = torch.zeros((), device="cuda")
            out = {}
            with torch.no_grad():
                for name, fn in (
                        ("no_plan", lambda: moe.moe_ffn(x, p, cfg)),
                        ("plan", lambda: moe.moe_ffn(x, p, cfg, plan)),
                        ("one_all_reduce", lambda: dist.all_reduce(
                            zero, group=mesh.get_group("model")))):
                    counts.update(all_reduce=0, all_gather=0)
                    fn()
                    per_call = dict(counts)
                    host, device = timed(fn, args.calls)
                    out[name] = {"collectives_a_call": per_call,
                                 "host_ms": host, "device_ms": device}
            del p, x
            dispatch = op_dispatch_us(args.calls * 10, TURNS)
            steps = {}
            for arch, layers in (("grok-1-314b", 2), ("qwen3-4b", 36)):
                steps[f"{arch}_{layers}_layers"] = decode_steps(
                    arch, layers, mesh, counts, args.steps, args.profile)
        finally:
            dist.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"moe_decode_b8_one_layer": out,
                      "decode_step_b8": steps,
                      "decode_launch_b8": dispatch,
                      "weight_fsdp": plan.weight_fsdp,
                      "moe_mode": plan.moe_mode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
