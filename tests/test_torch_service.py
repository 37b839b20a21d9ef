"""The port's LM PaaS wiring: engine replicas behind the balancer and the
supervisor, ServiceError / RequestError semantics for rejection and
shedding — each case of ``tests/test_service.py`` on the port's CPU
engine — and the service's Prometheus exposition against the
reference's for the same run.

The exposition run serves the same payloads (greedy and sampled, with
the reference's reduced qwen3-4b weights carried over through numpy)
through ``make_lm_service`` of both packages and scrapes
``service_prometheus_text`` and ``Supervisor.prometheus_text``: the
series (name and labels) are the same, and every series that is not a
time (``*_s``) has the same value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.core.supervisor import Supervisor as JaxSupervisor
from repro.models.model import build_model as jax_build
from repro.serve.service import make_lm_service as jax_make_lm_service
from repro.serve.service import (
    service_prometheus_text as jax_service_prometheus_text)
from repro_torch.configs.base import get_config
from repro_torch.core.services import RequestError, ServiceError
from repro_torch.core.supervisor import Supervisor
from repro_torch.models.model import build_model
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.engine import Request
from repro_torch.sharding.rules import ParallelPlan
from repro_torch.serve.service import (LMReplica, make_lm_service,
                                       service_prometheus_text)
from repro_torch.weights import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stack():
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0)


def _svc(model, params, name="lm", **kw):
    return make_lm_service(name, model, params, device="cpu", **kw)


def test_lm_service_serves_through_balancer_and_supervisor(stack):
    cfg, model, params = stack
    sup = Supervisor()
    svc = _svc(model, params, n_replicas=2, batch_size=2, max_seq=64,
               balancer_policy="least_loaded", with_backup=False,
               supervisor=sup)
    sup.start_all()
    out = svc({"prompt": [5, 6, 7], "max_new_tokens": 3})
    assert len(out["tokens"]) == 3
    assert out["replica"].startswith("lm/")
    st = sup.status()["lm"]
    assert st["healthy_replicas"] == 2
    assert st["upstream"]["served"] == 1


def test_lm_replica_client_errors_are_request_errors(stack):
    cfg, model, params = stack
    svc = _svc(model, params, n_replicas=1, batch_size=1, max_seq=16)
    svc.start()
    rep = svc.replicas[0].handler
    with pytest.raises(RequestError, match="max_seq"):
        rep({"prompt": [3] * 50})
    with pytest.raises(RequestError, match="expired"):
        rep({"prompt": [3, 4], "deadline_s": 0.0})


def test_client_error_does_not_poison_balancer(stack):
    cfg, model, params = stack
    svc = _svc(model, params, n_replicas=2, batch_size=1, max_seq=16,
               with_backup=False)
    svc.start()
    with pytest.raises(RequestError):
        svc({"prompt": [3] * 50})
    assert svc.balancer.stats["failovers"] == 0
    out = svc({"prompt": [5, 6, 7], "max_new_tokens": 2})
    assert len(out["tokens"]) == 2


def test_lm_replica_shed_is_request_error(stack):
    cfg, model, params = stack
    svc = _svc(model, params, name="lm_shed", n_replicas=1, batch_size=1,
               max_seq=64, policy="deadline")
    svc.start()
    rep = svc.replicas[0].handler
    vc = VirtualClock(start=1000.0)
    rep.scheduler.engine.clock = vc
    rep.scheduler.clock = vc
    rep.loop.clock = vc
    hog = rep.submit({"prompt": [3, 4], "max_new_tokens": 8})
    rep.loop.run_once()
    doomed = rep.submit({"prompt": [5, 6, 7], "max_new_tokens": 2,
                         "deadline_s": vc.now() + 1.0})
    rep.loop.run_once()
    vc.advance(5.0)
    with pytest.raises(RequestError, match="shed"):
        rep.loop.wait(doomed)
    assert len(rep.loop.wait(hog)["tokens"]) == 8


def test_lm_replica_queue_full_is_service_error(stack):
    cfg, model, params = stack
    svc = _svc(model, params, n_replicas=1, batch_size=1, max_seq=64,
               max_queue=1)
    svc.start()
    rep = svc.replicas[0].handler
    rep.scheduler.submit = lambda r: False
    with pytest.raises(ServiceError, match="queue full"):
        rep({"prompt": [3, 4, 5]})


def test_lm_replica_load_reports_queue_and_slots(stack):
    cfg, model, params = stack
    svc = _svc(model, params, n_replicas=1, batch_size=2, max_seq=64)
    rep: LMReplica = svc.replicas[0].handler
    assert rep.load() == 0
    rep.scheduler.engine.add_request(Request(rid=1, prompt=[4, 5, 6]))
    rep.scheduler.submit(Request(rid=2, prompt=[4, 5]))
    rep.scheduler.submit(Request(rid=3, prompt=[4, 5]))
    assert rep.load() == 3


def test_bad_sampling_payload_is_a_request_error(stack):
    cfg, model, params = stack
    svc = _svc(model, params, name="lm_samp", n_replicas=1, batch_size=1,
               max_seq=32)
    with pytest.raises(RequestError, match="bad sampling"):
        svc.replicas[0].handler({"prompt": [5, 6, 7],
                                 "sampling": {"temp": 0.9}})
    out = svc.replicas[0].handler({"prompt": [5, 6, 7],
                                   "max_new_tokens": 2,
                                   "sampling": {"temperature": 0.5,
                                                "seed": 3}})
    assert len(out["tokens"]) == len(out["logprobs"]) == 2


def test_non_dict_sampling_payload_is_a_request_error(stack):
    cfg, model, params = stack
    svc = _svc(model, params, name="lm_samp2", n_replicas=1, batch_size=1,
               max_seq=32)
    with pytest.raises(RequestError, match="sampling"):
        svc.replicas[0].handler({"prompt": [5, 6], "sampling": "greedy"})


def test_bad_speculation_payload_is_a_request_error(stack):
    cfg, model, params = stack
    svc = _svc(model, params, name="lm_spec", n_replicas=1, batch_size=1,
               max_seq=32)
    with pytest.raises(RequestError, match="speculation"):
        svc.replicas[0].handler({"prompt": [5, 6], "speculation": "2"})


# --------------------------------------------------- port-only behaviour
def test_later_slice_knobs_raise(stack):
    """A plan reaches every replica's engine (the multi-rank service runs
    in ``tests/test_torch_multirank.py``); a plan without a mesh serves
    the plain service's tokens. Speculation arms every replica's engine
    with its own draft runner, and a self-drafted service replies with
    the plain service's tokens. The replicas default to the card."""
    cfg, model, params = stack
    plan = ParallelPlan.make(None, cfg, "decode")
    planned = _svc(model, params, name="lm_plan", n_replicas=2,
                   batch_size=2, max_seq=32, plan=plan)
    assert all(r.handler.scheduler.engine.plan is plan
               for r in planned.replicas)
    spec = _svc(model, params, name="lm_spec2", n_replicas=2, batch_size=2,
                max_seq=32, draft_model=model, draft_params=params,
                speculation=2)
    plain = _svc(model, params, name="lm_plain", n_replicas=1,
                 batch_size=2, max_seq=32)
    engines = [r.handler.scheduler.engine for r in spec.replicas]
    assert all(e.spec_k == 2 and e.draft is not None for e in engines)
    assert engines[0].draft is not engines[1].draft
    payload = {"prompt": [5, 6, 7, 8], "max_new_tokens": 6}
    out = spec.replicas[0].handler(dict(payload))
    assert out["tokens"] == plain.replicas[0].handler(dict(payload))["tokens"]
    assert planned.replicas[0].handler(dict(payload))["tokens"] == \
        out["tokens"]
    assert engines[0].metrics["verify_steps"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="device"):
            make_lm_service("lm", model, params)


# ------------------------------------------- exposition vs the reference
PAYLOADS = [{"prompt": [5, 6, 7], "max_new_tokens": 3},
            {"prompt": [9, 4, 11, 30, 2], "max_new_tokens": 4,
             "sampling": {"temperature": 0.8, "top_k": 8, "seed": 3}},
            {"prompt": [7, 7, 7, 7, 7, 7, 7, 7, 7], "max_new_tokens": 2,
             "priority": 1}]


def _series(text):
    """{name{labels}: value} of every sample line."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _scrape(make, sup_cls, prom_text, model, params, **kw):
    sup = sup_cls()
    svc = make("lm", model, params, n_replicas=2, batch_size=2,
               max_seq=64, policy="priority", with_backup=True,
               supervisor=sup, **kw)
    sup.start_all()
    outs = [svc(dict(p)) for p in PAYLOADS]
    return outs, _series(prom_text(svc)), _series(sup.prometheus_text())


def test_prometheus_series_match_reference():
    jcfg = dataclasses.replace(jax_config("qwen3-4b").reduced(),
                               dtype=jnp.float32)
    cfg = get_config("qwen3-4b").reduced()
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jouts, jtext, jfleet = _scrape(jax_make_lm_service, JaxSupervisor,
                                   jax_service_prometheus_text, jmodel,
                                   jparams)
    outs, text, fleet = _scrape(make_lm_service, Supervisor,
                                service_prometheus_text,
                                build_model(cfg, device="cpu"), params,
                                device="cpu")
    for a, b in zip(jouts, outs):
        assert a["tokens"] == b["tokens"] and a["replica"] == b["replica"]
        np.testing.assert_allclose(b["logprobs"], a["logprobs"], atol=2e-5,
                                   rtol=2e-5)
    for got, want in ((text, jtext), (fleet, jfleet)):
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if not key.split("{")[0].endswith("_s"):
                assert got[key] == value, key
    assert 'engine_completed{replica="lm/0"}' in text
    assert 'balancer_served{service="lm"}' in text
    assert 'supervisor_up{service="lm"}' in fleet
