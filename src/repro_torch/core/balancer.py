"""NGINX-upstream semantics, in process (paper §3.3.1 / §4.3; own copy
of the reference's ``core/balancer.py``).

Reproduces the paper's upstream block:

    upstream parser-independent-PaaS {
        server ip1:p1 max_fails=3 fail_timeout=15s;
        server ip2:p2 max_fails=3 fail_timeout=15s;
        server ip3:p3 backup;
    }

Round-robin over healthy primaries; a primary that fails ``max_fails``
times inside a ``fail_timeout`` window is benched for ``fail_timeout``
seconds; the ``backup`` replica only serves while ALL primaries are
benched/down.

``policy="least_loaded"`` (NGINX ``least_conn`` analogue) routes each
request to the candidate reporting the smallest ``Replica.load()`` —
engine-backed LM replicas report queue depth + occupied slots, so long
generations stop head-of-line-blocking the other replicas.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from repro_torch.core.services import Replica, ServiceError


@dataclass
class _ReplicaState:
    fails: list = field(default_factory=list)   # failure timestamps
    benched_until: float = 0.0


class RoundRobinBalancer:
    def __init__(self, replicas: list[Replica], *, max_fails: int = 3,
                 fail_timeout: float = 15.0, clock=time.monotonic,
                 policy: str = "rr"):
        assert policy in ("rr", "least_loaded"), policy
        self.primaries = [r for r in replicas if not r.backup]
        self.backups = [r for r in replicas if r.backup]
        if not self.primaries:
            raise ValueError("need at least one primary replica")
        self.max_fails = max_fails
        self.fail_timeout = fail_timeout
        self.clock = clock
        self.policy = policy
        self._rr = 0
        self._lock = threading.Lock()
        self._state = {id(r): _ReplicaState() for r in replicas}
        self.stats = {"served": 0, "failovers": 0, "backup_served": 0}

    # ----------------------------------------------------------- metrics
    def metrics_snapshot(self) -> dict:
        """Upstream counters plus current bench state, flat and numeric
        — the shape ``MetricsRegistry.source`` polls, and what
        ``Supervisor.snapshot``/``status`` surface per service."""
        with self._lock:
            now = self.clock()
            return {**self.stats,
                    "benched": sum(1 for st in self._state.values()
                                   if st.benched_until > now),
                    "primaries": len(self.primaries),
                    "backups": len(self.backups)}

    # ----------------------------------------------------------- selection
    def _available(self, r: Replica) -> bool:
        return self._state[id(r)].benched_until <= self.clock()

    def _candidates(self) -> list[Replica]:
        prim = [r for r in self.primaries if self._available(r)]
        if prim:
            return prim
        return [r for r in self.backups if self._available(r)]

    def _record_failure(self, r: Replica) -> None:
        st = self._state[id(r)]
        now = self.clock()
        st.fails = [t for t in st.fails if now - t < self.fail_timeout]
        st.fails.append(now)
        if len(st.fails) >= self.max_fails:
            st.benched_until = now + self.fail_timeout
            st.fails = []

    # ----------------------------------------------------------- dispatch
    def __call__(self, payload, rng=None):
        attempts = 0
        last_err: Exception | None = None
        # a request may retry a failing primary until it crosses max_fails
        # and gets benched (then the backup pool takes over)
        budget = self.max_fails * len(self.primaries) + len(self.backups) + 1
        # streaming payloads carry an "on_token" callback. Each attempt
        # wraps it with a fresh delivery counter: a ServiceError BEFORE
        # the first token is an ordinary failover (the client observed
        # nothing), but once a token has streamed the request is NOT
        # replayed — a retry would re-deliver a divergent-length prefix
        # to a client that already consumed part of the stream. The
        # failure still counts against the replica's health.
        on_token = payload.get("on_token") if isinstance(payload, dict) \
            else None
        while attempts < budget:
            with self._lock:
                cands = self._candidates()
                if not cands:
                    break
                if self.policy == "least_loaded":
                    r = min(cands, key=lambda c: c.load())
                else:
                    r = cands[self._rr % len(cands)]
                self._rr += 1
            streamed = 0
            if on_token is not None:
                def _counting(tok, logp, _inner=on_token):
                    nonlocal streamed
                    _inner(tok, logp)
                    streamed += 1
                payload = dict(payload, on_token=_counting)
            try:
                out = r(payload, rng)
                with self._lock:
                    self.stats["served"] += 1
                    if r.backup:
                        self.stats["backup_served"] += 1
                return out
            except ServiceError as e:
                last_err = e
                attempts += 1
                with self._lock:
                    self._record_failure(r)
                    self.stats["failovers"] += 1
                if streamed:
                    raise ServiceError(
                        f"replica failed after streaming {streamed} "
                        f"tokens; not retrying a partially-delivered "
                        f"stream ({e})") from e
        raise ServiceError(
            f"all replicas unavailable ({last_err})") from last_err


def deploy(service, *, max_fails: int = 3, fail_timeout: float = 15.0,
           clock=time.monotonic, policy: str = "rr"):
    """Attach an upstream balancer to a Service (paper's single-uri
    upstreaming)."""
    service.balancer = RoundRobinBalancer(
        service.replicas, max_fails=max_fails, fail_timeout=fail_timeout,
        clock=clock, policy=policy)
    return service
