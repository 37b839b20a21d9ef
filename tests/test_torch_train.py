"""The port's train package against the JAX reference on the CPU.

``tests/test_substrate.py``'s data, optimizer, checkpoint and train-loop
tests, run on the port; then parity with the reference on the same
numpy inputs: ``schedule`` (1e-6 relative) and the packed batches
(equal); ``apply_updates`` over 6 steps (params, mu and nu within 1e-6
of each leaf's largest magnitude, the step count equal); checkpoints
written by either package restore in the other, a bfloat16 leaf
included, bit for bit; ``train`` for 3 steps from the reference's
weights (losses, grad norms and lr within 1e-5; every param within a
quarter of lr, 99.9 % of each leaf within 1e-5 of its largest
magnitude); a run resumed from its checkpoint and optimizer state
equals the continuous run bit for bit; ``python -m
repro_torch.launch.train --device cpu --steps 3`` exits 0; one NER
model trained on the synthetic corpus beats the majority class (the
port of ``tests/test_system.py::test_trained_ner_beats_chance``). Then
params that require grad (fresh from ``train``) serve exactly as
detached ones through ``ServingEngine``, the LM service and the CV
parser, and no model call of a serve records autograd.
"""
import dataclasses
import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic local shim, see requirements-dev
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.train import checkpoint as jax_checkpoint
from repro.train import optimizer as jax_opt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import PackedLMDataset as JaxDataset
from repro.train.train_loop import TrainerConfig as JaxTrainerConfig
from repro.train.train_loop import train as jax_train
from repro_torch.configs.base import get_config
from repro_torch.core import cvdata
from repro_torch.core.cvdata import SERVICE_LABELS, HashTokenizer
from repro_torch.core.pipeline import CVParser, NERModel
from repro_torch.models import bilstm_lan
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.service import make_lm_service
from repro_torch.train import checkpoint, optimizer as opt_mod, tree
from repro_torch.train.data import DataConfig, PackedLMDataset, \
    sharded_batches
from repro_torch.train.train_loop import TrainerConfig, train
from repro_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_tree(port, ref, tol):
    """Every leaf within ``tol`` of the reference leaf's largest |x|."""
    port = dict(tree.leaves_with_path(port))
    ref = {k: np.asarray(v, np.float32)
           for k, v in tree.leaves_with_path(ref)}
    assert port.keys() == ref.keys()
    for key, t in port.items():
        got = t.detach().float().numpy()
        scale = max(float(np.abs(ref[key]).max()), 1e-12)
        err = float(np.abs(got - ref[key]).max())
        assert err <= tol * scale, (key, err, scale)


# -------------------------------------------------------------------- data
def test_packing_is_deterministic_and_seekable():
    ds = PackedLMDataset(DataConfig(seq_len=32, batch_size=4))
    b1 = ds.batch(7)
    b2 = ds.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 33)


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=500))
def test_batches_cover_the_stream_without_padding(step):
    ds = PackedLMDataset(DataConfig(seq_len=16, batch_size=2))
    b = ds.batch(step)["tokens"]
    assert (b >= 0).all() and (b < 512).all()
    assert (b == 0).mean() < 0.05


def test_resume_matches_continuous_run():
    ds = PackedLMDataset(DataConfig(seq_len=16, batch_size=2))
    run1 = [b["tokens"] for b in ds.batches(6)]
    run2 = [b["tokens"] for b in ds.batches(3)] + \
           [b["tokens"] for b in ds.batches(3, start_step=3)]
    for a, b in zip(run1, run2):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dc", [dict(seq_len=16, batch_size=2),
                                dict(vocab_size=4096, seq_len=128,
                                     batch_size=8, n_documents=64, seed=3)])
def test_batches_equal_reference(dc):
    port = PackedLMDataset(DataConfig(**dc))
    ref = JaxDataset(JaxDataConfig(**dc))
    np.testing.assert_array_equal(port.stream, ref.stream)
    for step in (0, 1, 7, 500):
        np.testing.assert_array_equal(port.batch(step)["tokens"],
                                      ref.batch(step)["tokens"])
    got = list(sharded_batches(port, None, 2, start_step=5, device="cpu"))
    assert got[1]["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got[1]["tokens"].numpy(),
                                  ref.batch(6)["tokens"])


def test_sharded_batches_refuses_a_plan():
    ds = PackedLMDataset(DataConfig(seq_len=8, batch_size=1))
    with pytest.raises(NotImplementedError, match="item 4"):
        next(sharded_batches(ds, object(), 1, device="cpu"))


# -------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_multi_chunk(tmp_path):
    t = {"a": torch.arange(100_000, dtype=torch.float32).reshape(100, 1000),
         "b": {"c": torch.ones((7,), dtype=torch.bfloat16)},
         "l": [torch.arange(5, dtype=torch.int32)]}
    idx = checkpoint.save(tmp_path, "x", t, chunk_bytes=64 * 1024)
    assert len(idx["leaves"]["a"]["chunks"]) > 1      # actually chunked
    assert idx["leaves"]["b/c"]["dtype"] == "bfloat16"
    back = checkpoint.restore(tmp_path, "x", like=t)
    assert back["b"]["c"].dtype == torch.bfloat16
    for a, b in zip(tree.leaves(t), tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert checkpoint.list_checkpoints(tmp_path) == ["x"]


def test_checkpoint_detects_corruption(tmp_path):
    t = {"w": torch.ones((4096,), dtype=torch.float32)}
    checkpoint.save(tmp_path, "x", t, chunk_bytes=1024)
    f = next((tmp_path / "x" / "chunks").iterdir())
    blob = bytearray(f.read_bytes())
    blob[0] ^= 0xFF
    f.write_bytes(bytes(blob))
    with pytest.raises(IOError, match="checksum"):
        checkpoint.restore(tmp_path, "x", like=t)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    checkpoint.save(tmp_path, "x", {"w": torch.ones((4,))})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(tmp_path, "x", like={"w": torch.ones((5,))})


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((300, 70)).astype(np.float32),
            "blocks": {"bf": rng.standard_normal((9, 5)).astype(np.float32),
                       "ids": np.arange(11, dtype=np.int32)},
            "layers": [rng.standard_normal((4,)).astype(np.float32)]}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """Same index, keys, chunk files and bytes either way; a bfloat16
    leaf crosses as its raw words."""
    base = _mixed_tree(0)
    jtree = jax.tree.map(jnp.asarray, base)
    jtree["blocks"]["bf"] = jtree["blocks"]["bf"].astype(jnp.bfloat16)
    ttree = tree.tree_map(lambda a: torch.from_numpy(a.copy()), base)
    ttree["blocks"]["bf"] = ttree["blocks"]["bf"].to(torch.bfloat16)
    kw = dict(chunk_bytes=4096, metadata={"step": 3})
    if writer == "port":
        idx = checkpoint.save(tmp_path, "c", {"params": ttree}, **kw)
        want = jax_checkpoint.save(tmp_path / "ref", "c", {"params": jtree},
                                   **kw)
        back = jax_checkpoint.restore(tmp_path, "c", like={"params": jtree})
        pairs = zip(jax.tree.leaves(back), jax.tree.leaves(jtree))
        for a, b in pairs:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        idx = jax_checkpoint.save(tmp_path, "c", {"params": jtree}, **kw)
        want = checkpoint.save(tmp_path / "port", "c", {"params": ttree},
                               **kw)
        back = checkpoint.restore(tmp_path, "c", like={"params": ttree})
        for a, b in zip(tree.leaves(back), tree.leaves({"params": ttree})):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert idx == want
    assert json_keys(idx) == ["params/blocks/bf", "params/blocks/ids",
                              "params/layers/0", "params/w"]


def json_keys(index):
    return sorted(index["leaves"])


# --------------------------------------------------------------- optimizer
def test_adamw_converges_on_quadratic():
    oc = opt_mod.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                             total_steps=200)
    target = torch.tensor([3.0, -2.0])
    params = {"w": torch.zeros(2)}
    state = opt_mod.init_state(params)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(150):
        w = params["w"].clone().requires_grad_(True)
        g = torch.autograd.grad(loss({"w": w}), w)[0]
        params, state, m = opt_mod.apply_updates(params, {"w": g}, state, oc)
    assert float(loss(params)) < 1e-2


def test_grad_clipping_bounds_update():
    oc = opt_mod.AdamWConfig(clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = opt_mod.init_state(params)
    g = {"w": torch.tensor([1e6, 1e6, 1e6])}
    _, _, m = opt_mod.apply_updates(params, g, state, oc)
    assert float(m["grad_norm"]) > 1e5          # reported pre-clip


def test_warmup_cosine_schedule_shape():
    oc = opt_mod.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_ratio=0.1)
    lr0 = float(opt_mod.schedule(oc, 1))
    lr_peak = float(opt_mod.schedule(oc, 10))
    lr_end = float(opt_mod.schedule(oc, 100))
    assert lr0 == pytest.approx(0.1, abs=1e-6)
    assert lr_peak == pytest.approx(1.0, abs=1e-2)
    assert lr_end == pytest.approx(0.1, abs=1e-2)


@pytest.mark.parametrize("oc", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=7),
    dict(lr=1e-3, warmup_steps=10, total_steps=3)])
def test_schedule_equals_reference(oc):
    c, jc = opt_mod.AdamWConfig(**oc), jax_opt.AdamWConfig(**oc)
    for step in range(0, 120):
        want = float(jax_opt.schedule(jc, jnp.int32(step)))
        got = opt_mod.schedule(c, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("oc", [
    dict(lr=1e-2, warmup_steps=2, total_steps=6),            # clipped
    dict(lr=3e-3, warmup_steps=0, total_steps=6, clip_norm=1e3,
         weight_decay=0.0)])
def test_apply_updates_matches_reference_over_steps(oc):
    rng = np.random.default_rng(11)
    base = _mixed_tree(1)
    del base["blocks"]["ids"]
    jp = jax.tree.map(jnp.asarray, base)
    tp = tree.tree_map(lambda a: torch.from_numpy(a.copy()), base)
    js, ts = jax_opt.init_state(jp), opt_mod.init_state(tp)
    jc, c = jax_opt.AdamWConfig(**oc), opt_mod.AdamWConfig(**oc)
    for _ in range(6):
        g = tree.tree_map(lambda a: (rng.standard_normal(a.shape) * 3)
                          .astype(np.float32), base)
        jp, js, jm = jax_opt.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), js, jc)
        tp, ts, m = opt_mod.apply_updates(
            tp, tree.tree_map(torch.from_numpy, g), ts, c)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 6
    _close_tree(tp, jax.tree.map(np.asarray, jp), 1e-6)
    _close_tree(ts["mu"], jax.tree.map(np.asarray, js["mu"]), 1e-6)
    _close_tree(ts["nu"], jax.tree.map(np.asarray, js["nu"]), 1e-6)


def test_apply_updates_keeps_bf16_params_and_f32_moments():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt_mod.init_state(params)
    assert state["mu"]["w"].dtype == torch.float32
    opt_mod.apply_updates(params, {"w": torch.full((4,), 0.5,
                                                   dtype=torch.bfloat16)},
                          state, opt_mod.AdamWConfig(lr=0.1,
                                                     warmup_steps=0))
    assert params["w"].dtype == torch.bfloat16
    assert state["nu"]["w"].dtype == torch.float32
    assert float(params["w"][0]) < 1.0


# ------------------------------------------------------------ train loop
def _reduced(arch="qwen3-4b"):
    return get_config(arch).reduced()


def test_tiny_model_loss_decreases(tmp_path):
    cfg = _reduced()
    m = build_model(cfg, device="cpu")
    ds = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    batch_size=8))
    tc = TrainerConfig(n_steps=30, log_every=1, ckpt_root=str(tmp_path),
                       opt=opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5,
                                               total_steps=30))
    res = train(m, ds, tc)
    first = np.mean([h["loss"] for h in res.history[:5]])
    last = np.mean([h["loss"] for h in res.history[-5:]])
    assert last < first - 0.3, (first, last)


@pytest.mark.parametrize("arch", ["qwen3-4b", "grok-1-314b"])
def test_train_matches_reference(tmp_path, arch):
    """Three steps of both trainers from the reference's weights on the
    same packed batches: the logged metrics and the final params."""
    jmodel = jax_build(jax_config(arch).reduced())
    jparams = jmodel.init(jax.random.key(0))
    cfg = _reduced(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    dc = dict(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2)
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jres = jax_train(jmodel, JaxDataset(JaxDataConfig(**dc)),
                     JaxTrainerConfig(n_steps=3, log_every=1,
                                      ckpt_root=str(tmp_path / "ref"),
                                      opt=jax_opt.AdamWConfig(**oc)),
                     params=jax.tree.map(jnp.array, jparams))
    res = train(build_model(cfg, device="cpu"),
                PackedLMDataset(DataConfig(**dc)),
                TrainerConfig(n_steps=3, log_every=1,
                              ckpt_root=str(tmp_path / "port"),
                              opt=opt_mod.AdamWConfig(**oc)),
                params=params)
    assert [h["step"] for h in res.history] == [1, 2, 3]
    for h, jh in zip(res.history, jres.history):
        for key in ("loss", "xent", "aux", "grad_norm", "lr"):
            assert h[key] == pytest.approx(jh[key], rel=1e-5, abs=1e-7), key
    # Adam divides by sqrt(nu): a gradient component near eps whose last
    # bits differ between the frameworks moves its param by a visible
    # fraction of lr. So every param is held within a quarter of one
    # step's largest update, and 99.9 % of them within 1e-5 of the
    # leaf's largest magnitude.
    ref = dict(tree.leaves_with_path(params_from_numpy(
        jax.tree.map(np.asarray, jres.params), cfg, "cpu")))
    for key, t in tree.leaves_with_path(res.params):
        err = (t - ref[key]).abs()
        assert float(err.max()) <= 0.25 * oc["lr"], key
        near = err <= 1e-5 * float(ref[key].abs().max())
        assert float(near.float().mean()) >= 0.999, key
    assert not any(p.requires_grad for p in tree.leaves(res.params))


def test_resumed_run_equals_continuous_run(tmp_path):
    cfg = _reduced()
    model = build_model(cfg, device="cpu")
    ds = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    batch_size=2))
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)

    def tc(n, name):
        return TrainerConfig(n_steps=n, log_every=1, ckpt_every=3,
                             ckpt_root=str(tmp_path), ckpt_name=name, opt=oc)

    full = train(model, ds, tc(6, "full"), seed=4)
    half = train(model, ds, tc(3, "half"), seed=4)
    assert "half-3" in checkpoint.list_checkpoints(tmp_path)
    restored = checkpoint.restore(tmp_path, "half-3",
                                  like={"params": model.init(0)})["params"]
    rest = train(model, ds, tc(3, "rest"), params=restored,
                 opt_state=half.opt_state, start_step=3)
    assert [h["step"] for h in rest.history] == [4, 5, 6]
    for a, b in zip(full.history[3:], rest.history):
        assert a == b
    for a, b in zip(tree.leaves(full.params), tree.leaves(rest.params)):
        assert torch.equal(a, b)
    for key in ("mu", "nu"):
        for a, b in zip(tree.leaves(full.opt_state[key]),
                        tree.leaves(rest.opt_state[key])):
            assert torch.equal(a, b)
    final = checkpoint.restore(tmp_path, "full-final",
                               like={"params": full.params})["params"]
    for a, b in zip(tree.leaves(final), tree.leaves(full.params)):
        assert torch.equal(a, b)


def _launcher_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_launcher_trains_three_steps_on_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--ckpt-root", str(tmp_path)], env=_launcher_env(),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == ("training qwen3-4b (dense) on 1 device(s); "
                        "mesh=None")
    assert [ln.split()[1] for ln in lines[1:4]] == ["1", "2", "3"]
    assert "steps/s; loss" in lines[4]
    assert checkpoint.list_checkpoints(tmp_path) == ["qwen3-4b-final"]


def test_launcher_refuses_a_mesh(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "1", "--mesh-shape", "2,2", "--ckpt-root",
         str(tmp_path)], env=_launcher_env(), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert "NotImplementedError" in r.stderr and "item 4" in r.stderr


def test_trained_ner_beats_chance():
    """Train one section NER on the synthetic corpus for a few steps and
    check token accuracy clearly beats majority-class guessing."""
    name = "education"
    labels = SERVICE_LABELS[name]
    ner = NERModel.create(name, 0, device="cpu")
    tok = HashTokenizer(4096)
    rng = random.Random(0)
    sents = [cvdata._sent(rng, name) for _ in range(256)]
    X = np.array([tok.pad(tok.encode(s.tokens), 16) for s in sents],
                 np.int32)
    Y = np.array([[labels.index(lab) for lab in s.labels[:16]] +
                  [0] * (16 - len(s.labels[:16])) for s in sents], np.int32)
    M = (X != 0).astype(np.float32)
    Xt, Yt, Mt = (torch.from_numpy(a) for a in (X, Y, M))

    c = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=120,
                            weight_decay=0.0)
    params = ner.params
    state = opt_mod.init_state(params)
    leaves = tree.leaves(params)
    for _ in range(120):
        for p in leaves:
            p.requires_grad_(True)
        loss = bilstm_lan.loss(params, ner.cfg, Xt, Yt, Mt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g       # as jax.grad
                 for p, g in zip(leaves, grads)]
        params, state, _ = opt_mod.apply_updates(
            params, tree.unflatten(params, grads), state, c)
    with torch.no_grad():
        pred = bilstm_lan.predict(params, ner.cfg, Xt).numpy()
    acc = ((pred == Y) * M).sum() / M.sum()
    majority = max((Y[M > 0] == i).mean() for i in range(len(labels)))
    assert acc > majority + 0.15, (acc, majority)


# --------------------------------------------- trained params, then serving
def _requests():
    return [Request(i, prompt=list(range(2 + i, 10 + 2 * i)),
                    max_new_tokens=4) for i in range(3)]


def _grad_mode_spy(model, monkeypatch):
    """Record torch.is_grad_enabled() at every model call of a serve."""
    seen = []
    for name in ("prefill", "decode_step", "verify_step"):
        fn = getattr(type(model), name)

        def spy(self, *a, __fn=fn, **kw):
            seen.append(torch.is_grad_enabled())
            return __fn(self, *a, **kw)
        monkeypatch.setattr(type(model), name, spy)
    return seen


def test_params_requiring_grad_serve_as_detached(tmp_path, monkeypatch):
    cfg = _reduced()
    model = build_model(cfg, device="cpu")
    ds = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    batch_size=2))
    trained = train(model, ds, TrainerConfig(
        n_steps=2, log_every=1, ckpt_root=str(tmp_path))).params
    grad_params = tree.tree_map(
        lambda p: p.clone().requires_grad_(True), trained)
    streams = []
    seen = _grad_mode_spy(model, monkeypatch)
    for params in (trained, grad_params):
        eng = ServingEngine(model, params, batch_size=2, max_seq=64,
                            device="cpu")
        done = sorted(eng.run(_requests()), key=lambda r: r.rid)
        streams.append([(r.out_tokens, r.out_logprobs) for r in done])
        svc = make_lm_service("lm", model, params, batch_size=2, max_seq=64,
                              with_backup=False, device="cpu")
        svc.start()
        try:
            out = svc({"prompt": [5, 6, 7], "max_new_tokens": 3})
        finally:
            svc.stop()
        streams.append(out["tokens"])
    assert streams[0] == streams[2] and streams[1] == streams[3]
    assert seen and not any(seen)


def test_cv_parser_with_params_requiring_grad_parses_the_same():
    docs = cvdata.make_corpus(2, seed=1)
    parser = CVParser.create(0, device="cpu")
    want = [parser.parse(d)["fields"] for d in docs]
    for p in tree.leaves([parser.encoder_params, parser.classifier_params]):
        p.requires_grad_(True)
    for svc in parser.services.values():
        for r in svc.replicas:
            for p in tree.leaves(r.handler.params):
                p.requires_grad_(True)
    assert [parser.parse(d)["fields"] for d in docs] == want
    for svc in parser.services.values():
        svc.stop()
