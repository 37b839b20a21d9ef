"""Prediction-as-a-Service abstractions (paper §3.3; own copy of the
reference's ``core/services.py``, host-only Python).

A ``Service`` is a named prediction endpoint (one per CV section in the
paper; one per model in general). It is served by N ``Replica``s — the
paper deploys each PaaS on three machines, one marked ``backup``. Replicas
execute a handler; transport is in-process here (the pod analogue of the
paper's HTTP hop), with an optional latency model standing in for the
multi-machine cluster this container does not have.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


class ServiceError(RuntimeError):
    """Replica-side failure: the balancer retries elsewhere and counts it
    against the replica's health (max_fails benching)."""


class RequestError(RuntimeError):
    """Client-side error (oversized prompt, expired deadline): retrying
    on another replica cannot help, so it propagates straight to the
    caller without touching replica health."""


@dataclass
class LatencyModel:
    """Stand-in for remote-machine service time.

    Lognormal-ish sampler parameterized by (median, p75) so the paper's
    Fig-7 per-service distributions can be plugged in directly.
    """
    median_s: float = 0.0
    p75_s: float = 0.0
    _rng: Any = field(default=None, repr=False)

    def sample(self, rng) -> float:
        import math
        if self.median_s <= 0:
            return 0.0
        mu = math.log(self.median_s)
        sigma = max(math.log(max(self.p75_s, self.median_s * 1.01))
                    - mu, 1e-3) / 0.6745
        return float(rng.lognormvariate(mu, sigma))


@dataclass
class Replica:
    """One deployment of a service (the paper: one machine:port)."""
    name: str
    handler: Callable[[Any], Any]
    backup: bool = False
    latency: LatencyModel | None = None
    fail_rate: float = 0.0          # fault injection for balancer tests
    max_concurrency: int = 0        # worker slots; 0 = unlimited
    _up: bool = True
    calls: int = 0
    failures: int = 0
    _slots: Any = field(default=None, repr=False)

    def __post_init__(self):
        if self.max_concurrency:
            self._slots = threading.Semaphore(self.max_concurrency)

    def healthy(self) -> bool:
        return self._up

    def load(self) -> int:
        """Current load for least-loaded balancing: delegates to the
        handler (engine-backed LM replicas report queue + active slots);
        plain handlers report 0 (round-robin ties)."""
        fn = getattr(self.handler, "load", None)
        return int(fn()) if callable(fn) else 0

    def set_up(self, up: bool) -> None:
        going_down = self._up and not up
        self._up = up
        if going_down:
            self.abort()

    def abort(self) -> None:
        """Kill in-flight work when the replica goes down: streaming
        handlers expose ``abort()`` to fail their open streams with a
        retryable ServiceError (the balancer will NOT replay a stream
        whose first token was already delivered — see
        ``core/balancer.py``). Plain handlers have nothing in flight."""
        fn = getattr(self.handler, "abort", None)
        if callable(fn):
            fn()

    def _serve(self, payload, rng):
        if self.latency is not None and rng is not None:
            time.sleep(self.latency.sample(rng))
        return self.handler(payload)

    def __call__(self, payload, rng=None):
        self.calls += 1
        if not self._up:
            self.failures += 1
            raise ServiceError(f"replica {self.name} is down")
        if self.fail_rate and rng is not None and rng.random() < self.fail_rate:
            self.failures += 1
            raise ServiceError(f"replica {self.name} transient failure")
        if self._slots is None:
            return self._serve(payload, rng)
        with self._slots:               # queue for a worker slot
            return self._serve(payload, rng)


@dataclass
class Service:
    """A named PaaS endpoint backed by replicas behind a balancer."""
    name: str
    replicas: list = field(default_factory=list)
    priority: int = 2               # supervisor start priority (paper §4.3)
    depends_on: tuple = ()
    started: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    balancer: Any = None            # attached by deploy()

    def start(self) -> None:
        self.started = True

    def stop(self) -> None:
        self.started = False
        for r in self.replicas:
            r.abort()

    def __call__(self, payload, rng=None):
        if not self.started:
            raise ServiceError(f"service {self.name} not started")
        if self.balancer is None:
            # direct single-replica call
            return self.replicas[0](payload, rng)
        return self.balancer(payload, rng)
