"""A steady slice of a traced run under ``torch.profiler``: every device
activity (kernels, copies, fills) with its start and end on the host's
``perf_counter`` clock, the kernels' launch counts cross-checked against
the program's own counters, and the idle gaps labelled by what the serve
loop was doing.

The slice is delimited on the device itself: a marker kernel is launched
as it starts and another as it ends, and the activity between the two is
the slice's, placed on ``perf_counter`` by the line through the markers.
No wall-clock offset decides which launch belongs to it, so a wall clock
that is slewed during the run moves no kernel across its edges.

Only device activity is recorded, and nothing is written to disk. The
profiler still costs the host time at every launch, so the readings are
those of a profiled run: the harness prints the ticks a second before
the slice and in it.
"""
from __future__ import annotations

import bisect
import re
import time

import torch

# kernel families read by the per-layer metrics: the regular expression
# of their kernels' names, and those kernels that count one launch of the
# program's wrapper (the merge of a split paged call is part of the call)
FAMILIES = {
    "flash": (re.compile(r"(^|[\s:])flash_(mma_)?kernel\b"),
              re.compile(r"(^|[\s:])flash_(mma_)?kernel\b")),
    "paged": (re.compile(r"(^|[\s:])paged_(split|mma|merge)_kernel\b"),
              re.compile(r"(^|[\s:])paged_(split|mma)_kernel\b")),
}


# the marker kernel (``torch.cuda._sleep``), which the program never runs
MARKER = re.compile(r"(^|[\s:])spin_kernel\b")
MARK_CYCLES = 1000


class SourceGap(RuntimeError):
    """A metric's source lost data: the traced run must fail."""


def launch_counters() -> dict:
    """The program's launch counters of the kernel families."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.paged_attention.kernel import (
        paged_window_attention)
    return {"flash": flash_attention, "paged": paged_window_attention}


def short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:80]


def place(raw, t0: float, t1: float) -> list:
    """(name, start, end) in seconds on perf_counter of the device
    activity ``raw`` ((name, start_ns, duration_ns) in the profiler's
    clock) that started between the two marker kernels, mapped linearly
    so that the first marker starts at ``t0`` and the second at ``t1``.
    The markers themselves are left out."""
    marks = sorted(a for n, a, _ in raw if MARKER.search(n))
    if len(marks) != 2:
        raise SourceGap(f"the profiler recorded {len(marks)} of the slice's "
                        f"2 marker kernels")
    m0, m1 = marks
    if m1 <= m0:
        raise SourceGap("the slice's marker kernels have no length")
    k = (t1 - t0) / (m1 - m0)
    return [(n, t0 + (a - m0) * k, t0 + (a + d - m0) * k)
            for n, a, d in raw
            if m0 < a < m1 and not MARKER.search(n)]


def union(intervals, lo: float, hi: float):
    """The merged intervals of ``intervals`` clipped to [lo, hi]."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Slice:
    """Start and stop at tick boundaries; then ``events`` holds (name,
    start, end) of every device activity, in seconds on perf_counter."""

    def __init__(self, device):
        self.device = device
        self.t0 = self.t1 = None
        self.tick0 = self.tick1 = None
        self.events: list = []
        self.launches: dict = {}
        self.recorded = 0
        self._prof = None
        self._busy = (None, [])

    @property
    def running(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def start(self, tick: int) -> None:
        from torch.autograd.profiler import profile
        torch.cuda.synchronize(self.device)
        self._counters = launch_counters()
        self._n0 = {k: f.launches for k, f in self._counters.items()}
        # the autograd profiler, started and stopped by hand, so that
        # stopping it builds no Python event of each record
        self._prof = profile(use_device="cuda", use_cpu=False,
                             use_kineto=True)
        self._prof._prepare_trace()
        self._prof._start_trace()
        self.tick0 = tick
        self.t0 = time.perf_counter()
        self._mark()

    def _mark(self) -> None:
        with torch.cuda.device(self.device):
            torch.cuda._sleep(MARK_CYCLES)

    def end(self, tick: int) -> None:
        """Close the slice at a tick boundary. The profiler runs on, so
        that reading its buffers (``collect``) can wait until the run no
        longer serves anyone: it stalls the host for seconds."""
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.tick1 = tick
        self.launches = {k: f.launches - self._n0[k]
                         for k, f in self._counters.items()}
        self._mark()

    def collect(self) -> None:
        """Stop the profiler and keep the device activity that started
        between the slice's two markers. Every launch before ``end`` had
        finished by it (the synchronize) and by its marker, and every
        later one starts after that marker."""
        from torch.autograd import _disable_profiler
        from torch.autograd import profiler
        results = _disable_profiler()
        getattr(profiler, "_run_on_profiler_stop", lambda: None)()
        cuda = torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in results.events() if e.device_type() == cuda]
        self.recorded = len(raw)
        self.events = place(raw, self.t0, self.t1)
        self._prof = None

    # ----------------------------------------------------------- readings
    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The merged device activity, worked out once for the events as
        they stand (several readers ask for it)."""
        key = (len(self.events), self.t0, self.t1)
        if self._busy[0] != key:
            self._busy = (key, union(((a, b) for _, a, b in self.events),
                                     self.t0, self.t1))
        return self._busy[1]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def family_s(self, family: str) -> float:
        pat = FAMILIES[family][0]
        return sum(b - a for n, a, b in self.events if pat.search(n))

    def check(self) -> None:
        """Each family's profiled launches equal the program's count."""
        stray = [n for n, a, b in self.events
                 if b < self.t0 - 1e-3 or a > self.t1 + 1e-3]
        if stray:
            raise SourceGap(f"{len(stray)} device events lie outside the "
                            f"slice, e.g. {stray[0][:60]}")
        for fam, n in self.launches.items():
            pat = FAMILIES[fam][1]
            seen = sum(1 for name, _, _ in self.events if pat.search(name))
            if seen != n:
                raise SourceGap(f"{fam}: the program counted {n} launches "
                                f"in the slice, the profiler recorded {seen}")

    def breakdown(self, loop_spans: list) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the serve-loop phase (``loop_spans``: (name, start,
        end), one after another) the host was in at each gap's
        middle."""
        ops: dict = {}
        for n, a, b in self.events:
            k = short(n)
            ops[k] = ops.get(k, 0.0) + (b - a)
        gaps: dict = {}
        busy = self.busy()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        spans = sorted((s, e, n) for n, s, e in loop_spans)
        starts = [s for s, _, _ in spans]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            # the latest span to start at or before the gap's middle
            i = bisect.bisect_right(starts, mid) - 1
            label = spans[i][2] if i >= 0 and mid < spans[i][1] \
                else "between ticks"
            gaps[label] = gaps.get(label, 0.0) + (b - a)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}
