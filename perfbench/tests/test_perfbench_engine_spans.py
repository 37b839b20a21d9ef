"""The readers of the engine's own spans and counter (``launch_ms``,
``step_wall_device_ms``, ``moe_device_ms.decode``,
``prefill_device_ms.prefill``, ``prefill_pad_share.prefill``; their
entries: ``metrics/engine_spans.json``) on synthetic traces — the ticks
before the profiled slice only, the whole window without one, nothing
(None) where the program recorded nothing — and read through the harness
from traced tiny CPU cells."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
ENTRIES = json.loads((ROOT / "perfbench/metrics/engine_spans.json")
                     .read_text())["per_layer"]
NAMES = [m["name"] for m in ENTRIES]
SEED = 2**31 + 4243


def reader(name):
    return harness.Spec.reader(SimpleNamespace(dir=ROOT / "perfbench"), name)


def run_of(events, t0=None):
    """A run whose window is [10, 20) s, its profiled slice from ``t0``."""
    sl = None if t0 is None else SimpleNamespace(t0=t0)
    return harness.RunData({}, {}, [], 10.0, 20.0, 30.0, sl, list(events))


def span(name, pid, t, ms, **args):
    return {"name": name, "ph": "X", "pid": pid, "tid": 0, "ts": t * 1e6,
            "dur": ms * 1e3, "args": args}


def pad(t, tokens, padded):
    return {"name": "prefill-pad", "ph": "C", "pid": 3, "tid": 0,
            "ts": t * 1e6, "args": {"tokens": tokens, "pad": padded}}


# a trace whose window is [10, 20) s, the slice starting at 16 s: the
# reading takes 11 and 12, leaves 9 (before the window) and 17 (in the
# slice), and the other steps' spans, tracks and names
TRACE = [
    span("launch", 3, 9.0, 100.0, tick=0, phase="dispatch", step="decode"),
    span("launch", 3, 11.0, 4.0, tick=1, phase="dispatch", step="decode"),
    span("launch", 3, 12.0, 6.0, tick=2, phase="dispatch", step="decode"),
    span("launch", 3, 13.0, 50.0, tick=3, phase="dispatch", step="chunk"),
    span("launch", 3, 17.0, 90.0, tick=4, phase="dispatch", step="decode"),
    span("launch", 0, 12.5, 70.0),
    span("decode-step", 4, 9.0, 100.0, tick=0),
    span("decode-step", 4, 11.0, 20.0, tick=1),
    span("decode-step", 4, 12.0, 30.0, tick=2),
    span("chunk-step", 4, 13.0, 50.0, tick=3),
    span("decode-step", 4, 17.0, 90.0, tick=4),
    *[span("moe-ffn", 4, 11.0 + 0.001 * k, 2.0 + k, tick=1, layer=k,
           step="decode-step") for k in range(4)],
    *[span("moe-ffn", 4, 12.0 + 0.001 * k, 3.0, tick=2, layer=k,
           step="decode-step") for k in range(4)],
    span("moe-ffn", 4, 11.5, 40.0, tick=1, layer=0, step="prefill-call"),
    span("moe-ffn", 4, 17.0, 40.0, tick=4, layer=0, step="decode-step"),
    span("prefill-call", 4, 9.5, 500.0, tick=0, rows=1, width=8),
    span("prefill-call", 4, 11.5, 80.0, tick=1, rows=2, width=16),
    span("prefill-call", 4, 12.5, 100.0, tick=2, rows=1, width=32),
    span("prefill-call", 4, 17.5, 900.0, tick=4, rows=1, width=8),
    pad(9.5, 8, 8), pad(11.5, 32, 10), pad(12.5, 32, 6), pad(17.5, 8, 8),
    {"name": "process_name", "ph": "M", "pid": 3, "tid": 0,
     "args": {"name": "engine"}},
]

WANT = {"launch_ms": 5.0, "step_wall_device_ms": 25.0,
        "moe_device_ms.decode": ((2 + 3 + 4 + 5) + 4 * 3.0) / 2,
        "prefill_device_ms.prefill": 90.0,
        "prefill_pad_share.prefill": 100.0 * 16 / 64}
# without a slice the window runs to 20 s: the reading takes 17 too
WHOLE = {"launch_ms": (4.0 + 6.0 + 90.0) / 3,
         "step_wall_device_ms": (20.0 + 30.0 + 90.0) / 3,
         "moe_device_ms.decode": (14.0 + 12.0 + 40.0) / 3,
         "prefill_device_ms.prefill": (80.0 + 100.0 + 900.0) / 3,
         "prefill_pad_share.prefill": 100.0 * 24 / 72}


@pytest.mark.parametrize("name", NAMES)
def test_reader_takes_the_ticks_before_the_slice(name):
    assert reader(name)(run_of(TRACE, t0=16.0)) == pytest.approx(WANT[name])
    assert reader(name)(run_of(TRACE)) == pytest.approx(WHOLE[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_finds_nothing_without_the_engines_tracks(name):
    """A program without the engine's spans (the loop's spans alone), or
    a window that holds none of them: None, never a zero."""
    loop_only = [span("dispatch", 0, 11.0, 20.0), span("fill", 0, 11.1, 3.0)]
    assert reader(name)(run_of(loop_only, t0=16.0)) is None
    assert reader(name)(run_of(TRACE, t0=10.0)) is None
    assert reader(name)(run_of([])) is None


def test_a_zero_padding_share_is_a_reading():
    """Calls at their exact length read 0 %, which is not "absent"."""
    run = run_of([pad(11.0, 40, 0), pad(12.0, 24, 0)])
    assert reader("prefill_pad_share.prefill")(run) == 0.0


def test_entries_name_the_benchmarks_layers_and_metrics():
    """Each entry names a layer of the benchmark (or, for the step's wall
    time on the device, the two it spans), a metric of its own, cells that
    report the end-to-end metric it moves, and a reader."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    layers = {m["layer"] for m in bench["per_layer"]}
    layers.add("engine host work + model step")
    assert {"engine host work", "model step"} <= layers
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    have = {m["name"] for m in bench["per_layer"]}
    for m in ENTRIES:
        assert m["layer"] in layers and m["name"] not in have
        assert set(m["workloads"]) <= cells
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").exists()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny benchmark listing the five metrics, each in the tiny twins
    of its cells."""
    r = tiny.make(tmp_path_factory.mktemp("bench"))
    twin = {"deepseek7b-longprompt": "tiny-dense-open",
            "grok1-decode": "tiny-moe-closed"}
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["per_layer"] = [{**m, "moves": "itl_p95_ms",
                           "workloads": [twin[w] for w in m["workloads"]]}
                          for m in ENTRIES]
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    for m in ENTRIES:
        (r / "perfbench/metrics" / f"{m['name']}.py").write_text(
            (ROOT / "perfbench/metrics" / f"{m['name']}.py").read_text())
    return r


@pytest.mark.parametrize("cell, names", [
    ("tiny-dense-open", {"launch_ms", "step_wall_device_ms",
                         "prefill_device_ms.prefill",
                         "prefill_pad_share.prefill"}),
    ("tiny-moe-closed", {"launch_ms", "step_wall_device_ms",
                         "moe_device_ms.decode"})])
def test_a_traced_cell_reads_every_engine_metric(root, cell, names):
    """Through the harness, traced on the CPU (no profiled slice: the
    readers take the whole window): every metric of the cell reads a
    number (CPU times: the plain path's, not device numbers)."""
    res = harness.run_cell(root, cell, SEED, 1.0, True, device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == names
    for name in names - {"prefill_pad_share.prefill"}:
        assert res["metrics"][name]["value"] > 0
    if "prefill_pad_share.prefill" in names:
        assert 0 < res["metrics"]["prefill_pad_share.prefill"]["value"] < 100
