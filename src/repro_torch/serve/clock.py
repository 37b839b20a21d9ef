"""Virtual time for deterministic serving tests and harnesses (own copy
of the reference's ``serve/clock.py``).

Every clock-bearing component in the serving stack (engine, scheduler,
balancer, supervisor) takes an injectable ``clock`` — a zero-argument
callable returning seconds, ``time.perf_counter`` by default. A
:class:`VirtualClock` satisfies the same protocol but only moves when
the test advances it, so deadline/EDF shedding, SLO accounting, restart
backoff, and the async serve loop's arrival traces are exercised
without a single wall-clock sleep: a slow CI host cannot expire a
deadline the test meant to be live, and a test that "waits" 500 s
finishes instantly.

The clock is deliberately *passive* (no event queue): the serving stack
polls time, it never sleeps on it, so ``advance`` between loop ticks is
all a harness needs. ``sleep`` exists for components that back off
(supervisor restarts) — it advances instead of blocking.
"""
from __future__ import annotations


class VirtualClock:
    """Deterministic, manually-advanced clock.

    Callable like ``time.perf_counter`` (the protocol every serving
    component's ``clock`` parameter expects); ``advance``/``sleep`` move
    it forward. Never blocks, never goes backwards.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self.sleeps: list[float] = []      # every sleep(dt), for asserts

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clocks only move forward, got {dt}")
        self._t += dt
        return self._t

    def sleep(self, dt: float) -> None:
        """Drop-in for ``time.sleep`` that advances instead of blocking
        (and records the request, so tests can assert backoff behaviour
        without paying for it)."""
        self.sleeps.append(dt)
        self.advance(max(dt, 0.0))
