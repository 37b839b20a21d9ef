"""Each per-layer metric reader, and the slice's own readings, on a
synthetic trace: the numbers they should give, nothing (None) where
their source holds nothing, and a loud failure where it lost data."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import devtrace, harness, slicework, yardstick as ys
from perfbench import traffic
from perfbench.serve import Record

ROOT = Path(__file__).resolve().parents[2]
C = json.loads((ROOT / "perfbench/configs/grok-1-314b-4l.json")
               .read_text())["run"]
ENG = {"block_size": 16, "max_seq": 1536}
FLASH = "void (anonymous namespace)::flash_mma_kernel<128>(int)"
SPLIT = "void (anonymous namespace)::paged_split_kernel<__nv_bfloat16>(x)"
MERGE = "void (anonymous namespace)::paged_merge_kernel<128>(y)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32"


def reader(name):
    spec = SimpleNamespace(dir=ROOT / "perfbench")
    return harness.Spec.reader(spec, name)


def fake_slice(events, t0=10.0, t1=11.0, tick0=5, tick1=7):
    s = devtrace.Slice("cpu")
    s.t0, s.t1, s.tick0, s.tick1 = t0, t1, tick0, tick1
    s.events = events
    return s


def record(P, times, ticks, due, admitted=None):
    r = Record(traffic.Spec(0, [1] * P, len(times)), due)
    r.times, r.ticks = list(times), list(ticks)
    r.tokens = [0] * len(times)
    r.done = times[-1] if times else None
    r.handle = SimpleNamespace(request=SimpleNamespace(admitted_s=admitted),
                               done=True, error=None)
    return r


def run_of(records, sl, events=()):
    return harness.RunData(C, ENG, records, 10.0, 12.0, 20.0, sl,
                           list(events))


def test_union_busy_and_idle():
    sl = fake_slice([(GEMM, 10.0, 10.2), (FLASH, 10.1, 10.3),
                     (SPLIT, 10.5, 10.6), ("memcpy", 10.95, 11.2)])
    assert sl.busy_s == pytest.approx(0.3 + 0.1 + 0.05)
    assert reader("idle_share.decode")(run_of([], sl)) == \
        pytest.approx(55.0)
    assert reader("idle_share.prefill")(run_of([], fake_slice([]))) is None


def test_roofline_and_mfu_readers():
    # request A: prefill of 300 in tick 5, then tokens fed at 300, 301
    a = record(300, [10.1, 10.5, 10.9], [5, 6, 7], 9.9, admitted=10.05)
    b = record(100, [9.0, 10.5], [4, 6], 8.0, admitted=8.5)
    sl = fake_slice([(FLASH, 10.0, 10.004), (SPLIT, 10.4, 10.401),
                     (MERGE, 10.401, 10.4015), (GEMM, 10.6, 10.7)])
    run = run_of([a, b], sl)
    toks = sorted(slicework.tokens(run))
    assert toks == [(5, 300, 0), (6, 100, 1), (6, 300, 1)]
    f, by = ys.flash(1, 48, 8, 300, 300, 128)
    assert reader("flash_roofline.prefill")(run) == \
        pytest.approx(100 * 4 * ys.bound_s(f, by) / 0.004)
    pf, pb = ys.paged_window([100, 300], 1, 48, 8, 128, 16, 96)
    assert reader("paged_roofline.decode")(run) == \
        pytest.approx(100 * 4 * ys.bound_s(pf, pb) / 0.0015)
    flops = ys.prefill_flops(C, 300) + ys.decode_flops(C, 100) \
        + ys.decode_flops(C, 300)
    assert reader("mfu.decode")(run) == pytest.approx(
        100 * flops / (sl.busy_s * ys.PEAK_FLOPS_BF16))
    quiet = fake_slice([(GEMM, 10.6, 10.7)])
    assert reader("flash_roofline.prefill")(run_of([a, b], quiet)) is None
    assert reader("paged_roofline.decode")(run_of([a, b], quiet)) is None
    assert reader("mfu.prefill")(run_of([], quiet)) is None


def test_queue_wait_and_dispatch_readers():
    recs = [record(10, [10.5], [1], 10.0 + i * 0.1, admitted=10.2 + i * 0.1)
            for i in range(19)]
    recs.append(record(10, [], [], 11.0, admitted=None))    # never admitted
    recs.append(record(10, [9.0], [0], 9.0, admitted=9.5))  # due before
    run = run_of(recs, None)
    # 20 due in the window; the 95th percentile is the 19th: 200 ms,
    # the 20th (never admitted) stands at 20.0 - 11.0 s
    assert reader("queue_wait_p95_ms")(run) == pytest.approx(200.0)
    recs[0].handle.request.admitted_s = None
    assert reader("queue_wait_p95_ms")(run) == pytest.approx(9000.0)
    ev = [{"ph": "X", "name": "dispatch", "ts": 10.5e6, "dur": 4000.0},
          {"ph": "X", "name": "dispatch", "ts": 11.0e6, "dur": 6000.0},
          {"ph": "X", "name": "dispatch", "ts": 13.0e6, "dur": 9e6},
          {"ph": "X", "name": "fill", "ts": 11.0e6, "dur": 1e6}]
    assert reader("dispatch_ms.decode")(run_of([], None, ev)) == \
        pytest.approx(5.0)
    assert reader("dispatch_ms.decode")(run_of([], None, ev[2:])) is None


def test_launch_counts_must_match_the_program():
    sl = fake_slice([(FLASH, 10.1, 10.2), (SPLIT, 10.3, 10.4),
                     (MERGE, 10.4, 10.5)])
    sl.launches = {"flash": 1, "paged": 1}
    sl.check()
    sl.launches = {"flash": 2, "paged": 1}
    with pytest.raises(devtrace.SourceGap, match="flash"):
        sl.check()
    sl.launches = {"flash": 1, "paged": 1}
    sl.events.append((GEMM, 12.5, 12.6))
    with pytest.raises(devtrace.SourceGap, match="outside"):
        sl.check()


def test_the_slice_is_placed_by_its_marker_kernels():
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    # profiler ns, on a clock 1,000 s off the host's and running 0.1 % fast
    raw = [(GEMM, 1_009_000_000_000, 5_000_000),       # before the slice
           (mark, 1_010_000_000_000, 1_000),
           (FLASH, 1_010_100_100_000, 1_001_000),
           (SPLIT, 1_010_500_500_000, 2_002_000),
           (mark, 1_011_001_000_000, 1_000),
           (MERGE, 1_011_002_000_000, 1_000_000)]      # after it
    ev = devtrace.place(raw, 10.0, 11.0)
    assert [n for n, _, _ in ev] == [FLASH, SPLIT]
    assert ev[0][1:] == pytest.approx((10.1, 10.101))
    assert ev[1][1:] == pytest.approx((10.5, 10.502))
    with pytest.raises(devtrace.SourceGap, match="1 of the slice's 2"):
        devtrace.place(raw[:4], 10.0, 11.0)


def test_breakdown_labels_gaps_by_the_loop_phase():
    sl = fake_slice([(GEMM, 10.0, 10.3), (FLASH, 10.5, 10.6),
                     (GEMM, 10.6, 10.8)])
    spans = [("dispatch", 10.25, 10.55), ("emit", 10.8, 10.95)]
    # the gap 10.8-11.0 has its middle in emit
    bd = sl.breakdown(spans)
    assert bd["device_ops"][0] == ["sm90_xmma_gemm_bf16bf16_bf16f32",
                                   pytest.approx(0.5)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "dispatch": pytest.approx(0.2), "emit": pytest.approx(0.2)}
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_first_token_and_answer_tails():
    recs = [record(10, [10.0 + 0.1 * i + 0.05, 10.0 + 0.1 * i + 0.3],
                   [1, 2], 10.0 + 0.1 * i, admitted=10.0 + 0.1 * i)
            for i in range(19)]
    late = record(10, [], [], 11.95)                 # never answered
    late.done = None
    recs.append(late)
    run = run_of(recs, None)
    # 20 due in the window; the 20th stands at gave_up 20.0 - 11.95 s
    assert reader("first_token_p95_ms")(run) == pytest.approx(50.0)
    assert reader("answer_p95_ms")(run) == pytest.approx(300.0)
    recs[0].error = "RequestError('shed')"
    assert reader("answer_p95_ms")(run) == pytest.approx(8050.0)
    assert reader("first_token_p95_ms")(run_of([], None)) is None
