"""supervisord semantics, in process (paper §3.3.1 / §4.3; own copy of
the reference's ``core/supervisor.py``).

The paper's supervisor.conf starts services in priority order:
    0: Tika (text extraction)   1: BERT encoder
    2: per-section PaaS         3: CV-Parser front-end
with auto-restart. This module reproduces: priority-ordered startup,
dependency verification (a service never starts before everything at a
lower priority / in ``depends_on`` is up), restart-with-backoff, and a
``supervisorctl``-style status view.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.services import Service, ServiceError


@dataclass
class Supervisor:
    services: dict = field(default_factory=dict)
    max_restarts: int = 3
    backoff_s: float = 0.0          # 0 in tests; supervisord default 1s
    # injectable so tests drive restart backoff on a virtual clock
    # (VirtualClock.sleep records and advances instead of blocking)
    sleep: object = time.sleep
    events: list = field(default_factory=list)
    # restart accounting, surfaced by snapshot(): per-service failed
    # start attempts (across every _start call's retries), and the
    # services that ever exhausted their max_restarts budget
    restart_attempts: dict = field(default_factory=dict)
    exhausted: set = field(default_factory=set)

    def add(self, svc: Service) -> Service:
        self.services[svc.name] = svc
        return svc

    # ------------------------------------------------------------- startup
    def start_all(self) -> list[str]:
        """Start every service in (priority, insertion) order, verifying
        dependencies. Returns the startup order."""
        order = sorted(self.services.values(),
                       key=lambda s: (s.priority,
                                      list(self.services).index(s.name)))
        started: list[str] = []
        for svc in order:
            for dep in svc.depends_on:
                if dep not in self.services:
                    raise ServiceError(f"{svc.name}: unknown dependency {dep}")
                if not self.services[dep].started:
                    raise ServiceError(
                        f"{svc.name}: dependency {dep} not started "
                        f"(priority ordering violated)")
            self._start(svc)
            started.append(svc.name)
        return started

    def _start(self, svc: Service) -> None:
        attempts = 0
        while True:
            try:
                svc.start()
                self.events.append(("started", svc.name, attempts))
                return
            except Exception:  # noqa: BLE001 — supervisor retries anything
                attempts += 1
                self.restart_attempts[svc.name] = \
                    self.restart_attempts.get(svc.name, 0) + 1
                self.events.append(("start-failed", svc.name, attempts))
                if attempts > self.max_restarts:
                    self.exhausted.add(svc.name)
                    raise
                if self.backoff_s:
                    self.sleep(self.backoff_s * attempts)

    # ------------------------------------------------------------- control
    def restart(self, name: str) -> None:
        svc = self.services[name]
        svc.stop()
        self._start(svc)

    def stop_all(self) -> None:
        for svc in reversed(list(self.services.values())):
            svc.stop()
            self.events.append(("stopped", svc.name, 0))

    def status(self) -> dict:
        """supervisorctl status analogue, enriched with replica health
        and upstream (balancer) counters when a service is deployed."""
        out = {}
        for name, s in self.services.items():
            row = {
                "state": "RUNNING" if s.started else "STOPPED",
                "priority": s.priority,
                "replicas": len(s.replicas),
                "healthy_replicas": sum(1 for r in s.replicas if r.healthy()),
                "load": sum(r.load() for r in s.replicas),
            }
            if s.balancer is not None:
                row["upstream"] = dict(s.balancer.stats)
            out[name] = row
        return out

    def snapshot(self) -> dict:
        """``status()`` enriched with restart accounting — per-service
        failed start attempts and whether the restart budget was ever
        exhausted — plus the supervisor-wide budget, so a fleet
        dashboard sees flapping services before they die for good."""
        out = self.status()
        for name, row in out.items():
            row["restart_attempts"] = self.restart_attempts.get(name, 0)
            row["restarts_exhausted"] = name in self.exhausted
            row["max_restarts"] = self.max_restarts
        return out

    def prometheus_text(self) -> str:
        """One Prometheus exposition across every deployed service:
        each LM replica's metrics registry (labelled per replica),
        each balancer's upstream counters (labelled per service), and
        the supervisor's own restart accounting — the fleet-level
        scrape endpoint."""
        from repro_torch.serve.telemetry import MetricsRegistry, prometheus_text
        regs = []
        for name, s in self.services.items():
            for r in s.replicas:
                reg = getattr(r.handler, "registry", None)
                if reg is not None:
                    regs.append(reg)
            bal = getattr(s, "balancer", None)
            if bal is not None and hasattr(bal, "metrics_snapshot"):
                breg = MetricsRegistry(labels={"service": name})
                breg.source("balancer", bal.metrics_snapshot)
                regs.append(breg)
            sreg = MetricsRegistry(labels={"service": name})
            sreg.source("supervisor", lambda n=name: {
                "restart_attempts": self.restart_attempts.get(n, 0),
                "restarts_exhausted":
                    1 if n in self.exhausted else 0,
                "max_restarts": self.max_restarts,
                "up": 1 if self.services[n].started else 0})
            regs.append(sreg)
        return prometheus_text(regs)

    def unhealthy(self) -> list[str]:
        """Services with zero healthy replicas — restart candidates."""
        return [name for name, s in self.services.items()
                if s.started and s.replicas
                and not any(r.healthy() for r in s.replicas)]
