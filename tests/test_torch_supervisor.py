"""supervisord semantics: priority startup order, dependency gating,
restart, status.

Each case of ``tests/test_supervisor.py`` on the port's own copy
(``repro_torch.core.supervisor``)."""
import pytest

from repro_torch.core.services import Replica, Service, ServiceError
from repro_torch.core.supervisor import Supervisor
from repro_torch.serve.clock import VirtualClock


def svc(name, priority, deps=()):
    return Service(name, replicas=[Replica(f"{name}/0", lambda p: p)],
                   priority=priority, depends_on=deps)


def paper_stack():
    """The paper's §4.3 priority layout."""
    sup = Supervisor()
    sup.add(svc("tika", 0))
    sup.add(svc("bert", 1, deps=("tika",)))
    for s in ("personal_information", "education", "work_experience",
              "skills", "functional_area"):
        sup.add(svc(s, 2, deps=("bert",)))
    sup.add(svc("cv_parser", 3, deps=("tika", "bert",
                                      "personal_information", "education",
                                      "work_experience", "skills",
                                      "functional_area")))
    return sup


def test_startup_order_respects_priority():
    sup = paper_stack()
    order = sup.start_all()
    assert order[0] == "tika"
    assert order[1] == "bert"
    assert order[-1] == "cv_parser"
    assert set(order[2:7]) == {"personal_information", "education",
                               "work_experience", "skills",
                               "functional_area"}


def test_dependency_violation_raises():
    sup = Supervisor()
    sup.add(svc("cv_parser", 0, deps=("bert",)))   # bert at HIGHER priority
    sup.add(svc("bert", 1))
    with pytest.raises(ServiceError, match="priority ordering"):
        sup.start_all()


def test_unknown_dependency_raises():
    sup = Supervisor()
    sup.add(svc("a", 0, deps=("ghost",)))
    with pytest.raises(ServiceError, match="unknown dependency"):
        sup.start_all()


def test_restart_and_status():
    sup = paper_stack()
    sup.start_all()
    sup.restart("bert")
    st = sup.status()
    assert st["bert"]["state"] == "RUNNING"
    assert st["cv_parser"]["priority"] == 3
    sup.stop_all()
    assert all(v["state"] == "STOPPED" for v in sup.status().values())


def test_flaky_start_retries():
    attempts = {"n": 0}

    class Flaky(Service):
        def start(self):
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RuntimeError("boom")
            super().start()

    # restart backoff runs on an injected sleep: the virtual clock
    # records each wait and advances instead of blocking the test
    vc = VirtualClock()
    sup = Supervisor(max_restarts=5, backoff_s=1.0, sleep=vc.sleep)
    sup.add(Flaky("flaky", replicas=[Replica("f/0", lambda p: p)],
                  priority=0))
    sup.start_all()
    assert attempts["n"] == 3
    assert sup.services["flaky"].started
    assert vc.sleeps == [1.0, 2.0]       # linear backoff, zero wall-clock


# ------------------------------------------------- restart accounting
def test_snapshot_counts_restart_attempts():
    attempts = {"n": 0}

    class Flaky(Service):
        def start(self):
            attempts["n"] += 1
            if attempts["n"] < 3:
                raise RuntimeError("boom")
            super().start()

    sup = Supervisor(max_restarts=5)
    sup.add(Flaky("flaky", replicas=[Replica("f/0", lambda p: p)],
                  priority=0))
    sup.add(svc("steady", 1))
    sup.start_all()
    snap = sup.snapshot()
    assert snap["flaky"]["restart_attempts"] == 2      # two failed starts
    assert snap["flaky"]["restarts_exhausted"] is False
    assert snap["flaky"]["max_restarts"] == 5
    assert snap["flaky"]["state"] == "RUNNING"
    assert snap["steady"]["restart_attempts"] == 0
    # snapshot keeps everything status() reports
    assert snap["steady"]["priority"] == 1
    assert "replicas" in snap["steady"]


def test_snapshot_marks_exhausted_restart_budget():
    class Dead(Service):
        def start(self):
            raise RuntimeError("always down")

    sup = Supervisor(max_restarts=2)
    sup.add(Dead("dead", replicas=[Replica("d/0", lambda p: p)],
                 priority=0))
    with pytest.raises(RuntimeError, match="always down"):
        sup.start_all()
    snap = sup.snapshot()
    # max_restarts=2 allows 3 start attempts before giving up
    assert snap["dead"]["restart_attempts"] == 3
    assert snap["dead"]["restarts_exhausted"] is True
    assert snap["dead"]["state"] == "STOPPED"


def test_restart_attempts_accumulate_across_restarts():
    fail_next = {"on": False}

    class Sometimes(Service):
        def start(self):
            if fail_next["on"]:
                fail_next["on"] = False
                raise RuntimeError("hiccup")
            super().start()

    sup = Supervisor(max_restarts=3)
    sup.add(Sometimes("svc", replicas=[Replica("s/0", lambda p: p)],
                      priority=0))
    sup.start_all()
    assert sup.snapshot()["svc"]["restart_attempts"] == 0
    fail_next["on"] = True
    sup.restart("svc")                   # one failure, then recovers
    snap = sup.snapshot()
    assert snap["svc"]["restart_attempts"] == 1
    assert snap["svc"]["state"] == "RUNNING"
    assert snap["svc"]["restarts_exhausted"] is False
