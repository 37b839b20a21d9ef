#!/usr/bin/env python3
"""The engine's spans on the card: the benchmark's cells, traced and
untraced, through ``perfbench.harness`` (no file of ``perfbench/`` is
changed), with the engine's five per-layer metrics added to a copy of
``BENCHMARK.json`` (``perfbench/metrics/engine_spans.json``).

    python scripts/torch_engine_spans.py --cells deepseek7b-longprompt,\
grok1-decode --seeds 11,12,13 [--modes untraced,traced] [--seconds 51]
        [--tree DIR] [--out FILE.jsonl] [--device cuda]

``--tree`` runs another checkout's program and benchmark (an unpacked
``git archive``); a program without the engine's spans is measured
without the five metrics. Each run prints one ``SPANS`` JSON line (also
appended to ``--out``):

* ``correct``, the harness's metrics (end to end untraced, per layer
  traced; a traced run that prints them dropped no event), or the
  ``SourceGap`` the run met and the profiler's count of records;
* over the window before the profiled slice (untraced: the same
  seconds of the window): ticks a second, ``itl_p95_ms``, output tokens
  a second and the mean ``dispatch`` span (traced);
* traced, with the engine's spans: ``agree``, the share of the slice's
  device-busy time (the profiler's, marker kernels left out) inside the
  ``*-step`` and ``prefill-call`` device spans widened by 20 µs at each
  edge, the kernels most outside them, and for each kernel family the
  share of its time and of its launches inside a widened ``moe-ffn``
  span, the ``moe-ffn`` spans in the slice by the number of bf16 GEMM
  (``nvjet``) launches each holds, the shortest such launch inside a
  decode step's span and the longest outside every span, and for each
  kind of device span the device's busy share inside it (the rest is
  the device waiting for the host); ``gaps``, the slice's idle time
  summed by the engine sub-span the host was in at each gap's middle
  (beside the harness's own breakdown by loop phase).

Prints the card's name and power limit first. Give each traced run a
process of its own (one seed, one cell, one mode a call): a traced run
that came second in its process lost a slice marker both times it was
tried.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
EDGE = 20e-6          # seconds each span is widened by at each edge
DEVICE, ENGINE = 4, 3


def widened(ev, pred) -> list:
    """The merged device spans whose name ``pred`` accepts, each widened
    by ``EDGE`` at both ends."""
    from perfbench.devtrace import union
    return union(((e["ts"] / 1e6 - EDGE, (e["ts"] + e["dur"]) / 1e6 + EDGE)
                  for e in ev if e.get("ph") == "X" and e.get("pid") == DEVICE
                  and pred(e["name"])), -math.inf, math.inf)


def overlap(a: float, b: float, spans: list, starts: list) -> float:
    """The length of [a, b] covered by ``spans`` (merged, sorted; their
    starts in ``starts``)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    got = 0.0
    while i < len(spans) and spans[i][0] < b:
        got += max(0.0, min(b, spans[i][1]) - max(a, spans[i][0]))
        i += 1
    return got


def agreement(run) -> dict:
    """How the program's device spans cover the profiler's slice."""
    from perfbench.devtrace import short
    sl, ev = run.slice, run.tracer_events
    steps = widened(ev, lambda n: n.endswith("-step") or n == "prefill-call")
    moe = widened(ev, lambda n: n == "moe-ffn")
    s_starts, m_starts = [s for s, _ in steps], [s for s, _ in moe]
    busy = sl.busy()
    b_starts = [a for a, _ in busy]
    total = sum(b - a for a, b in busy)
    inside = sum(overlap(a, b, steps, s_starts) for a, b in busy)
    # the device's busy share inside each kind of span in the slice (the
    # rest is the device waiting for the host inside the span)
    held: dict = {}
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") == DEVICE:
            a, b = e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6
            if sl.t0 <= a and b <= sl.t1:
                h = held.setdefault(e["name"], [0.0, 0.0])
                h[0] += b - a
                h[1] += overlap(a, b, busy, b_starts)
    outside: dict = {}
    fams: dict = {}
    for n, a, b in sl.events:
        k = short(n)
        miss = (b - a) - overlap(a, b, steps, s_starts)
        if miss > 0:
            outside[k] = outside.get(k, 0.0) + miss
        f = fams.setdefault(k, [0.0, 0.0, 0, 0])
        f[0] += b - a
        f[1] += overlap(a, b, moe, m_starts)
        f[2] += 1
        i = bisect.bisect_right(m_starts, a) - 1
        f[3] += i >= 0 and b <= moe[i][1]
    top = sorted(fams.items(), key=lambda kv: -kv[1][0])[:8]
    # the bf16 GEMM launches (``nvjet``) each widened moe-ffn span of a
    # decode step holds, and the longest such launch outside every span
    spans = sorted((e["ts"] / 1e6 - EDGE, (e["ts"] + e["dur"]) / 1e6 + EDGE,
                    e["args"]["step"]) for e in ev if e.get("ph") == "X"
                   and e.get("pid") == DEVICE and e["name"] == "moe-ffn"
                   and sl.t0 <= e["ts"] / 1e6 < sl.t1)
    n_held = [0] * len(spans)
    out_max = in_min = None
    lo = [s for s, _, _ in spans]
    for n, a, b in sl.events:
        if not short(n).startswith("nvjet"):
            continue
        i = bisect.bisect_right(lo, a) - 1
        if i >= 0 and b <= spans[i][1]:
            n_held[i] += 1
            if spans[i][2] == "decode-step":
                in_min = b - a if in_min is None else min(in_min, b - a)
        else:
            out_max = b - a if out_max is None else max(out_max, b - a)
    per_span: dict = {}
    for (_, _, step), k in zip(spans, n_held):
        per_span[f"{step}:{k}"] = per_span.get(f"{step}:{k}", 0) + 1
    return {"busy_s": total, "inside_steps_s": inside,
            "moe_spans": len(spans), "gemms_per_moe_span": per_span,
            "gemm_in_decode_moe_min_s": in_min,
            "gemm_outside_moe_max_s": out_max,
            "share": inside / total if total else None,
            "busy_in_span": {k: [t, b / t if t else None]
                             for k, (t, b) in sorted(held.items())},
            "outside_top": sorted(outside.items(),
                                  key=lambda kv: -kv[1])[:5],
            "moe_families": [[k, t, m / t if t else None, n, c]
                             for k, (t, m, n, c) in top],
            "device_events": len(sl.events)}


def gaps(run) -> list:
    """The slice's idle seconds by the engine sub-span the host was in at
    each gap's middle (the harness's breakdown, over the ``engine``
    track instead of the loop's)."""
    sub = [(e["name"], e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
           for e in run.tracer_events
           if e.get("ph") == "X" and e.get("pid") == ENGINE]
    return run.slice.breakdown(sub)["idle_gaps"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="untraced,traced")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    tree = Path(a.tree).resolve() if a.tree else REPO
    sys.path[:0] = [str(tree / "src"), str(tree)]
    from perfbench import run as bench_run
    bench_run._environment()
    import torch

    from perfbench import devtrace, endtoend, harness, serve
    from repro_torch.serve import telemetry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() \
        if a.device == "cuda" else a.device
    print(smi, torch.__version__, flush=True)
    spans = hasattr(telemetry, "PID_DEVICE")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    if spans:
        bench["per_layer"] += json.loads(
            (tree / "perfbench/metrics/engine_spans.json").read_text()
        )["per_layer"]
    seconds = a.seconds or float(bench["run_seconds"])

    runs, stacks, opens, slices = [], [], [], []

    class RunCapture(harness.RunData):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append(self)

    class StackCapture(serve.Stack):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.pumps = []
            stacks.append(self)

        def pump(self):
            super().pump()
            self.pumps.append(serve.clock())

    class SliceCapture(devtrace.Slice):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            slices.append(self)

    def opening(fn, i):
        def wrapped(*args):
            opens.append(args[i])
            return fn(*args)
        return wrapped

    harness.RunData = RunCapture
    serve.Stack = StackCapture
    devtrace.Slice = SliceCapture
    serve.run_open = opening(serve.run_open, 2)
    serve.run_closed = opening(serve.run_closed, 3)

    def measure(root, cell, seed, mode) -> dict:
        for xs in (runs, stacks, opens, slices):
            xs.clear()
        row = {"tree": str(a.tree or "."), "cell": cell, "seed": seed,
               "mode": mode}
        try:
            res = harness.run_cell(root, cell, seed, seconds,
                                   mode == "traced", device=a.device)
        except devtrace.SourceGap as e:
            # what ``perfbench/run.py`` exits 4 for
            sl = slices[-1] if slices else None
            return {**row, "error": f"source gap: {e}",
                    "recorded": sl.recorded if sl else None,
                    "ticks": stacks[-1].tick if stacks else None}
        stk, t_open = stacks[-1], opens[-1]
        run = runs[-1] if runs else None
        sl = run.slice if run is not None else None
        t_end = sl.t0 if sl is not None and sl.t0 is not None \
            else t_open + seconds - min(0.5 * seconds, harness.SLICE_S)
        w = t_end - t_open
        itl = [g * 1e3 for g in endtoend.gaps(stk.records, t_open, t_end)]
        row.update(correct=res["correct"], failed=res["failed"],
                   metrics={k: v["value"] for k, v in
                            res["metrics"].items()},
                   before_slice={
                       "seconds": w,
                       "ticks_per_s": sum(t_open <= p < t_end
                                          for p in stk.pumps) / w,
                       "itl_p95_ms": endtoend.pct(itl, 0.95)
                       if itl else None,
                       "output_tok_s": endtoend.tokens_in(
                           stk.records, t_open, t_end) / w})
        if run is not None:
            ds = [e["dur"] / 1e3 for e in run.tracer_events
                  if e.get("ph") == "X" and e["name"] == "dispatch"
                  and t_open <= e["ts"] / 1e6 < t_end]
            row["before_slice"]["dispatch_ms"] = \
                sum(ds) / len(ds) if ds else None
            row["events"] = len(run.tracer_events)
        if sl is not None:
            row.update(busy_s=sl.busy_s, window_s=sl.window_s,
                       recorded=sl.recorded, in_slice=len(sl.events),
                       breakdown=res.get("breakdown"))
            if spans:
                row["agree"] = agreement(run)
                row["gaps"] = gaps(run)
        return row

    out = Path(a.out) if a.out else None
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        (root / "perfbench").symlink_to(tree / "perfbench")
        for seed in [int(x) for x in a.seeds.split(",")]:
            for cell in a.cells.split(","):
                for mode in a.modes.split(","):
                    line = json.dumps(measure(root, cell, seed, mode))
                    print("SPANS " + line, flush=True)
                    if out:
                        with out.open("a") as f:
                            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
