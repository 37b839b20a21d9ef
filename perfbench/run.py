"""The benchmark of ``repro_torch``, the PyTorch and CUDA serving port: one
run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It makes the weights and the traffic from
the seed, serves through the program's paged engine on the card, warms
up, measures for ``--seconds``, checks what the window served against the
plain reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics read
from a profiled slice (``--trace 1``). A cell on more than one card runs
one process a card under a process group (``torch.distributed``).

Build and kernel caches stay inside the checkout (``build/`` and
``perfbench/out/``). Exit codes: 0 a result was printed; 2 no card, or
fewer than the cell asks for; 3 a forbidden module was loaded; 4 a
metric's source lost data.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "perfbench" / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(OUT / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_loaded(modules=None) -> list:
    """Modules loaded (``modules``, else ``sys.modules``) whose top-level
    name (before the first dot) is one the port must never load, compared
    whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def args_of(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _rank_main(rank, world, port, args, device_type, queue):
    """One rank of a multi-card cell: every rank serves the same requests
    in step under a decode ``ParallelPlan`` over a (1, world) mesh; rank
    0's clock decides arrivals. Rank 0 puts the result on ``queue``."""
    _environment()
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from perfbench import harness
    from repro_torch.sharding.rules import ParallelPlan
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        ctl = dist.new_group(backend="gloo")
        mesh = init_device_mesh(device_type, (1, world),
                                mesh_dim_names=("data", "model"))
        sp = harness.Spec(ROOT if args.root is None else args.root,
                          args.workload)
        cfg, _ = harness.arch_config(sp.config)
        plan = ParallelPlan.make(mesh, cfg, "decode")

        def sync(t):
            buf = torch.tensor([t], dtype=torch.float64)
            dist.broadcast(buf, 0, group=ctl)
            return float(buf[0])

        device = torch.device(device_type, rank) if device_type == "cuda" \
            else torch.device("cpu")
        res = harness.run_cell(args.root or ROOT, args.workload, args.seed,
                               args.seconds, bool(args.trace), device=device,
                               t_start=args.t_start, plan=plan, sync=sync)
        dev = res["device"]
        peak = torch.tensor([dev["memory_peak_bytes"]], dtype=torch.float64)
        dist.all_reduce(peak, dist.ReduceOp.MAX, group=ctl)
        dev["memory_peak_bytes"] = int(peak[0])
        dev["count"] = world
        if "busy_s" in dev:
            busy = torch.tensor([dev["busy_s"]], dtype=torch.float64)
            dist.all_reduce(busy, group=ctl)
            dev["busy_s"] = float(busy[0]) / world
        if rank == 0:
            queue.put(res)
    finally:
        dist.destroy_process_group()


def run_ranks(args, world: int, device_type: str) -> dict:
    """Start one process a card, wait for every one, return rank 0's
    result."""
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, args, device_type, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    res = None
    try:
        res = queue.get(timeout=3000)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode for p in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    return res


def report(res: dict) -> None:
    """The notes and the numbers compared on standard error, last the
    result line on standard output."""
    for line in res.pop("notes", []):
        print(line, file=sys.stderr)
    res.pop("readings", None)
    checks = res.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    print(json.dumps(line))


def main(argv=None) -> int:
    _environment()
    args = args_of(argv)
    args.root, args.t_start = None, T_START
    import torch
    from perfbench import devtrace, harness
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    chips = int(cells[args.workload]["chips"]) if args.workload in cells \
        else 1
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    try:
        if chips > 1:
            res = run_ranks(args, chips, "cuda")
        else:
            res = harness.run_cell(ROOT, args.workload, args.seed,
                                   args.seconds, bool(args.trace),
                                   t_start=T_START)
    except devtrace.SourceGap as e:
        print(f"source gap: {e}", file=sys.stderr)
        return 4
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    report(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
