"""NGINX-upstream semantics: round-robin, max_fails/fail_timeout benching,
backup promotion, recovery.

Each case of ``tests/test_balancer.py`` on the port's own copy
(``repro_torch.core.balancer``)."""
import pytest

from repro_torch.core.balancer import RoundRobinBalancer
from repro_torch.core.services import Replica, ServiceError


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def mk(name, **kw):
    return Replica(name, handler=lambda p: (name, p), **kw)


def test_round_robin_is_fair():
    reps = [mk("a"), mk("b"), mk("c")]
    lb = RoundRobinBalancer(reps)
    for _ in range(30):
        lb("x")
    assert [r.calls for r in reps] == [10, 10, 10]


def test_failed_primary_is_benched_and_backup_serves():
    clock = FakeClock()
    a, b = mk("a"), mk("backup", backup=True)
    lb = RoundRobinBalancer([a, b], max_fails=3, fail_timeout=15.0,
                            clock=clock)
    a.set_up(False)
    out, _ = lb("x")          # fails over to backup after benching a
    assert out == "backup"
    assert lb.stats["backup_served"] == 1
    # a benched: requests keep landing on backup without touching a
    calls_before = a.calls
    lb("y")
    assert a.calls == calls_before


def test_benched_primary_recovers_after_fail_timeout():
    clock = FakeClock()
    a, b = mk("a"), mk("backup", backup=True)
    lb = RoundRobinBalancer([a, b], max_fails=1, fail_timeout=15.0,
                            clock=clock)
    a.set_up(False)
    lb("x")
    a.set_up(True)
    clock.t = 16.0            # past fail_timeout -> unbenched
    out, _ = lb("y")
    assert out == "a"


def test_backup_not_used_while_primaries_healthy():
    a, b, bk = mk("a"), mk("b"), mk("backup", backup=True)
    lb = RoundRobinBalancer([a, b, bk])
    for _ in range(20):
        lb("x")
    assert bk.calls == 0


def test_all_down_raises():
    clock = FakeClock()
    a, bk = mk("a"), mk("backup", backup=True)
    lb = RoundRobinBalancer([a, bk], max_fails=1, clock=clock)
    a.set_up(False)
    bk.set_up(False)
    with pytest.raises(ServiceError):
        lb("x")


def test_max_fails_window_semantics():
    """Failures older than fail_timeout don't count toward max_fails."""
    clock = FakeClock()
    a, b = mk("a"), mk("b")
    lb = RoundRobinBalancer([a, b], max_fails=3, fail_timeout=15.0,
                            clock=clock)
    st = lb._state[id(a)]
    for i in range(2):
        lb._record_failure(a)
        clock.t += 20.0        # each failure expires before the next
    assert st.benched_until <= clock.t   # never benched


# ------------------------------------------------------------ least-loaded
class _LoadedHandler:
    def __init__(self, load):
        self._load = load
        self.calls = 0

    def load(self):
        return self._load

    def __call__(self, payload):
        self.calls += 1
        return payload


def test_least_loaded_routes_to_idlest_replica():
    busy, idle = _LoadedHandler(5), _LoadedHandler(0)
    reps = [Replica("busy", busy), Replica("idle", idle)]
    lb = RoundRobinBalancer(reps, policy="least_loaded")
    for i in range(8):
        lb(i)
    assert idle.calls == 8 and busy.calls == 0


def test_least_loaded_falls_back_on_plain_handlers():
    """Handlers without load() report 0 -> stable first-candidate pick,
    still correct (no crash, no lost request)."""
    reps = [mk("a"), mk("b")]
    lb = RoundRobinBalancer(reps, policy="least_loaded")
    for i in range(6):
        assert lb(i)[1] == i
    assert reps[0].calls + reps[1].calls == 6
