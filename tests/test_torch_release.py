"""What a user drops is freed when the last reference goes, without the
cycle collector: an engine, a scheduler, an async loop, an LM service
and a ``train()`` run release their params, optimizer state and caches
at once. On the card those are gigabytes that Python's cycle collector
does not know about: it runs when enough Python objects were made, not
when device memory runs short, so an object left in a reference cycle
keeps its tensors until the collector happens to run.

Each case runs with the collector off, drops everything it made, and
checks through weak references that every tensor of the params (and,
for ``train()``, of the returned optimizer state) is gone.
"""
import gc
import tempfile
import weakref

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train import tree

CFG = get_config("qwen3-4b").reduced()


def _reqs():
    g = torch.Generator().manual_seed(1)
    return [Request(rid=i, prompt=torch.randint(2, CFG.vocab_size, (n,),
                                                generator=g).tolist(),
                    max_new_tokens=4) for i, n in enumerate((5, 20, 9))]


def _engine(model, params, **kw):
    return ServingEngine(model, params, batch_size=4, max_seq=64,
                         block_size=8, device="cpu", use_kernel=True, **kw)


def _serve(model, params):
    _engine(model, params).run(_reqs())


def _speculate(model, params):
    _engine(model, params, draft_model=model, draft_params=params,
            speculation=2).run(_reqs())


def _dispatch(model, params):
    """A tick left uncommitted holds its engine: dropping both frees it."""
    eng = _engine(model, params)
    eng.add_requests(_reqs())
    eng.dispatch_step().commit()
    eng.dispatch_step()


def _scheduler(model, params):
    from repro_torch.serve.scheduler import Scheduler
    sched = Scheduler(_engine(model, params), policy="priority")
    for r in _reqs():
        sched.submit(r)
    sched.drain()


def _async_loop(model, params):
    from repro_torch.serve.async_loop import AsyncServeLoop
    from repro_torch.serve.scheduler import Scheduler
    loop = AsyncServeLoop(Scheduler(_engine(model, params)))
    handles = [loop.submit(r) for r in _reqs()]
    loop.start()
    try:
        for h in handles:
            h.result()
    finally:
        loop.stop()


def _service(model, params):
    """An LM replica's metrics registry polls its loop and scheduler; the
    sources must not refer back to the replica."""
    from repro_torch.core.supervisor import Supervisor
    from repro_torch.serve.service import (make_lm_service,
                                           service_prometheus_text)
    sup = Supervisor()
    svc = make_lm_service("lm", model, params, batch_size=4, max_seq=64,
                          use_kernel=True, supervisor=sup, device="cpu")
    sup.start_all()
    rep = svc.replicas[0].handler
    rep.loop.start()
    try:
        assert len(svc({"prompt": [3, 4, 5, 6], "max_new_tokens": 3})
                   ["tokens"]) == 3
        assert "engine_completed" in service_prometheus_text(svc)
    finally:
        rep.loop.stop()
        sup.stop_all()


def _train(model, params):
    """``train()`` rebuilds params and state with ``tree.unflatten``; its
    result, dropped, frees them."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.data import DataConfig, PackedLMDataset
    from repro_torch.train.train_loop import TrainerConfig, train
    ds = PackedLMDataset(DataConfig(vocab_size=CFG.vocab_size, seq_len=16,
                                    batch_size=2))
    oc = opt_mod.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=2)
    with tempfile.TemporaryDirectory() as ck:
        res = train(model, ds, TrainerConfig(n_steps=2, log_every=1,
                                             ckpt_root=ck, ckpt_name="x",
                                             opt=oc), params=params)
    return [weakref.ref(t) for t in tree.leaves(res.opt_state)]


@pytest.mark.parametrize("case", [_serve, _speculate, _dispatch, _scheduler,
                                  _async_loop, _service, _train],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_dropped_objects_free_their_tensors_without_the_collector(case):
    gc.collect()
    gc.disable()
    try:
        model = build_model(CFG, device="cpu")
        params = model.init(0)
        refs = [weakref.ref(t) for t in tree.leaves(params)]
        refs += case(model, params) or []
        del model, params
        alive = sum(r() is not None for r in refs)
        assert alive == 0, f"{alive} of {len(refs)} tensors outlive {case}"
    finally:
        gc.enable()


def test_unflatten_leaves_no_cycle():
    """``tree.unflatten``'s result is the only thing holding its leaves."""
    gc.collect()
    gc.disable()
    try:
        leaves = [torch.zeros(3) for _ in range(4)]
        refs = [weakref.ref(t) for t in leaves]
        out = tree.unflatten({"a": [0, 0], "b": {"c": 0, "d": 0}}, leaves)
        del leaves
        assert all(r() is not None for r in refs)
        del out
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
