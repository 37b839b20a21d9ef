"""One run of one cell: find its files by the names in ``BENCHMARK.json``,
make the weights, build the program's serving stack, warm up, measure,
then judge what the window served against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under the benchmark's folder:
``configs/<config>.json`` (the path ``BENCHMARK.json`` gives),
``traffic/<mix>.json``, ``metrics/<metric>.py`` (a ``read(run)`` that
returns a number or None), ``checks/<cell>.json`` (the limits of the
numbers that decide ``correct``: a number of ``correct.COMPARED`` is
compared where that file gives it a limit, and a cell compares one at
least).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from perfbench import correct, devtrace, endtoend, serve, traffic, weights

TRACER_CAPACITY = 4_000_000
SLICE_S = 8.0


class Spec:
    """The cell's entries in ``BENCHMARK.json`` and its data files."""

    def __init__(self, root, cell: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = bench
        self.dir = self.root / bench["paths"][0]
        cells = {w["name"]: w for w in bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no cell named {cell!r} in BENCHMARK.json")
        self.cell = cells[cell]
        confs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = confs[self.cell["config"]]
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.dir / "traffic" / f"{self.cell['traffic']}.json")
            .read_text())
        checks = self.dir / "checks" / f"{cell}.json"
        self.checks = json.loads(checks.read_text()) if checks.exists() \
            else {}

        def mine(m):
            return cell in m.get("workloads", [cell])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, name: str):
        path = self.dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def arch_config(conf: dict):
    """The program's ``ArchConfig`` as the configuration file runs it, and
    the plain dict of its sizes the yardstick and reference read."""
    from repro_torch.configs.base import get_config
    run = dict(conf["run"])
    dtype = getattr(torch, run.pop("dtype"))
    base = get_config(conf["arch"])
    cfg = dataclasses.replace(base, dtype=dtype, remat=False, **run)
    c = dict(conf["run"])
    return cfg, c


def check_layout(model, params) -> None:
    """The weights' tree has the leaves, shapes and dtypes the program's
    own (meta) init gives."""
    from repro_torch.models.model import Model
    meta = Model(model.cfg, torch.device("meta")).init()
    want = {k: (tuple(v.shape), v.dtype) for k, v in
            weights.flat(meta).items()}
    have = {k: (tuple(v.shape), v.dtype) for k, v in
            weights.flat(params).items()}
    if want != have:
        raise ValueError(f"weights layout differs from the program's: "
                         f"{sorted(set(want.items()) ^ set(have.items()))}")


@dataclass
class RunData:
    """What a per-layer metric reader reads."""
    c: dict
    engine: dict
    records: list
    t_open: float
    t_close: float
    gave_up: float
    slice: object
    tracer_events: list


def _warm_specs(mix: dict, vocab: int) -> list:
    """A request for each prefill shape class of the mix's prompt range
    (its ends and each power of two between), two tokens out."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    sizes = {lo, hi} | {1 << k for k in range(20) if lo < (1 << k) < hi}
    g = torch.Generator().manual_seed(0)
    return [traffic.Spec(-1 - i, torch.randint(0, vocab, (n,),
                                               generator=g).tolist(), 2)
            for i, n in enumerate(sorted(sizes))]


def run_cell(root, cell: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None, plan=None,
             sync=None, control: bool = False,
             overrides: dict | None = None, judge: bool = True) -> dict:
    """Run the cell once. Returns a dict: ``correct``, ``attempted``,
    ``failed``, ``metrics`` {name: {value, unit}}, ``device``,
    ``breakdown`` (traced), ``checks`` {name: {value, limit}} and
    ``notes`` (lines for standard error). ``control`` also reads the
    fp8 control's numbers and judges them by the same limits
    (``control_correct``: for setting the limits; runs of the benchmark
    do not). ``overrides replaces keys of the traffic mix and
    ``judge=False`` skips the comparison (both for the knee sweep)."""
    t_start = time.perf_counter() if t_start is None else t_start
    gc.collect()
    sp = Spec(root, cell)
    mix = {**sp.traffic, **(overrides or {})}
    eng = mix["engine"]
    cfg, c = arch_config(sp.config)
    device = torch.device(device)
    cuda = device.type == "cuda"
    from repro_torch.models.model import build_model
    from repro_torch.serve.telemetry import Tracer
    t_imp = time.perf_counter()
    model = build_model(cfg, device)
    params = weights.make(c, seed, device)
    check_layout(model, params)
    if cuda:
        torch.cuda.synchronize(device)
    t_w = time.perf_counter()
    tracer = Tracer(clock=serve.clock, capacity=TRACER_CAPACITY) \
        if trace else None
    stk = serve.Stack(model, params, eng, device=device, tracer=tracer,
                       plan=plan, sync=sync)
    serve.warm_up(stk, _warm_specs(mix, c["vocab_size"]))
    t_warm = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    sl = devtrace.Slice(device) if trace and cuda else None
    # the window's last SLICE_S seconds: some tens of prefills in the
    # document cell, and few enough device events that the profiler's
    # buffers hold them all
    slice_s = min(0.5 * seconds, SLICE_S)
    backlog = []
    pool = stk.engine.pool
    high_water = [0]
    tick_open = []

    def on_tick(d):
        now = serve.clock()
        high_water[0] = max(high_water[0], pool.used)
        if not tick_open and now >= t_open:
            tick_open.append((d.tick, now))
        if mix["loop"] == "open":
            # requests due and not yet in a slot (each is sent when due)
            backlog.append((now - t_open, sum(
                1 for r in d.records if r.request.admitted_s is None)))
        if sl is None:
            return
        # the slice ends with the window; its buffers are read once
        # every request is served (``collect``)
        if sl.t0 is None and now >= t_open + seconds - slice_s:
            sl.start(d.tick)
        elif sl.running and now >= sl.t0 + slice_s:
            sl.end(d.tick)

    preroll = float(mix.get("preroll_s", 0.0))
    t_open = stk.now() + preroll
    if mix["loop"] == "open":
        specs = traffic.open_loop(mix, seed, seconds, c["vocab_size"])
        gave_up = serve.run_open(stk, specs, t_open, seconds,
                                 float(mix.get("grace_s", 60.0)), on_tick)
    else:
        stream = traffic.ClosedStream(mix, seed, c["vocab_size"])
        gave_up = serve.run_closed(stk, stream, int(mix["clients"]), t_open,
                                   seconds, on_tick)
    t_served = serve.clock()
    if sl is not None and sl.t0 is not None:
        if sl.running:
            sl.end(stk.tick)
        sl.collect()
    t_collected = serve.clock()
    t_close = t_open + seconds
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    kv_token = 2 * c["n_layers"] * c["n_kv_heads"] * c["head_dim"] \
        * getattr(torch, c["dtype"]).itemsize
    bs = int(eng["block_size"])
    notes = [f"setup: start to config {t_imp - t_start} s, weights "
             f"{t_w - t_imp} s, engine and warm-up {t_warm - t_w} s, "
             f"preroll {preroll} s",
             f"pool high-water {high_water[0]} of {pool.total} blocks: "
             f"{high_water[0] * bs} tokens, "
             f"{high_water[0] * bs * kv_token} of "
             f"{pool.total * bs * kv_token} bytes of KV"]
    result = {"attempted": 0, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    result["attempted"], result["failed"] = endtoend.counts(
        stk.records, mix["loop"], t_open, t_close)
    if not trace:
        vals, more = endtoend.compute([m["name"] for m in sp.end_to_end],
                                       stk.records, t_open, t_close,
                                       gave_up, t_open - t_start)
        notes += more
        for m in sp.end_to_end:
            v, unit = vals[m["name"]]
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        if tracer.dropped:
            raise devtrace.SourceGap(f"the tracer dropped {tracer.dropped} "
                                     f"events")
        events = tracer.chrome_trace()["traceEvents"]
        if sl is not None:
            sl.check()
        run = RunData(c, eng, stk.records, t_open, t_close, gave_up, sl,
                      events)
        t_read = serve.clock()
        for m in sp.per_layer:
            v = sp.reader(m["name"])(run)
            if v is None:
                raise devtrace.SourceGap(f"{m['name']}: its source recorded "
                                         f"nothing in this run")
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if sl is not None:
            result["device"]["busy_s"] = sl.busy_s
            result["device"]["window_s"] = sl.window_s
            loop_spans = [(e["name"], e["ts"] / 1e6,
                           (e["ts"] + e["dur"]) / 1e6) for e in events
                          if e.get("ph") == "X" and e.get("pid") == 0]
            result["breakdown"] = sl.breakdown(loop_spans)
            notes.append(f"slice ticks {sl.tick0}-{sl.tick1} launches "
                         f"{sl.launches} window_s {sl.window_s} device "
                         f"events {len(sl.events)} of {sl.recorded} "
                         f"recorded")
            if tick_open:
                k, t = tick_open[0]
                notes.append(
                    f"ticks a second: the window before the slice "
                    f"{(sl.tick0 - k) / (sl.t0 - t)}, the slice "
                    f"{(sl.tick1 - sl.tick0) / sl.window_s}")
        notes.append(f"after the window: serving {t_served - t_close} s, "
                     f"profiler read {t_collected - t_served} s, readers "
                     f"{serve.clock() - t_read} s")
    result["notes"] = notes
    result["backlog"] = backlog
    result["pool_high_water_blocks"] = high_water[0]
    records = stk.records
    stk.close()
    del stk, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not judge:
        return result
    # ---- correctness, after the window, with the program's state freed
    recs = correct.sample(records, seed, int(mix["check"]["served_tokens"]))
    margin = float(sp.checks.get("served_gap_max", {})
                   .get("router_margin", 0.0))
    t_ref = serve.clock()
    reads = correct.readings(params, c, recs, control=control,
                             router_margin=margin)
    notes.append(f"reference {serve.clock() - t_ref} s")
    notes.append("readings " + json.dumps(reads))
    checks = {name: {"value": reads[name],
                     "limit": sp.checks[name]["limit"]}
              for name in correct.COMPARED
              if sp.checks.get(name, {}).get("limit") is not None}
    ok = bool(recs) and bool(checks) and within(checks)
    checks["failed"] = {"value": result["failed"], "limit": 0}
    result["correct"] = ok and result["failed"] == 0
    result["checks"] = checks
    result["readings"] = reads
    if control:
        # the control in the program's place, judged by the same limits
        result["control_correct"] = bool(recs) and within(
            {name: {"value": reads["control_" + name.removeprefix("served_")],
                    "limit": checks[name]["limit"]}
             for name in correct.COMPARED if name in checks})
    return result


def within(checks: dict) -> bool:
    """Every number has a limit, is finite and is at most its limit."""
    return all(c["limit"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())
