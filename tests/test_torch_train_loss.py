"""The port's losses and their gradients against the JAX reference on the
CPU.

``softmax_xent`` with and without a mask, at a padded vocabulary (ids
past the vocabulary at -1e9, as ``_logits`` leaves them), agrees with
the reference's within 1e-6. ``Model.train_loss`` and every gradient
agree with ``jax.value_and_grad`` of the reference's at reduced width
(2 layers, d 256, f32; the reference's ``init_params`` weights carried
over through numpy by ``params_from_numpy``, the same numpy batch) for
the dense ``qwen3-4b`` (MHA, and G 2 over a padded vocabulary of 500),
the MoE ``grok-1-314b`` (a non-zero aux loss), ``rwkv6-1.6b``,
``hymba-1.5b``, ``whisper-tiny`` and ``qwen2-vl-2b``: the loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest magnitude.
With ``remat`` the gradients equal those without it, bit for bit. The
section classifier's ``classifier_loss`` and the NER model's
``bilstm_lan.loss`` agree in value (1e-6 relative) and gradient (1e-4
of each leaf's largest magnitude).

On the CPU attention runs the plain masked softmax, not the flash op;
the flash backward is held to its plain version on the card and the
plain version to ``jax.vjp`` in ``test_torch_flash_backward.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import bert_encoder as jax_bert
from repro.models import bilstm_lan as jax_lan
from repro.models import layers as jax_layers
from repro.models.model import build_model as jax_build
from repro_torch.configs.base import get_config
from repro_torch.models import bert_encoder, bilstm_lan, layers
from repro_torch.models.model import build_model
from repro_torch.train import tree
from repro_torch.weights import (classifier_params_from_numpy,
                                 lan_params_from_numpy, params_from_numpy)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4                 # of each leaf's largest |g|
B, S = 2, 8
# (arch, config overrides)
CASES = {
    "qwen3-4b": ("qwen3-4b", {}),
    "qwen3-4b-g2-v500": ("qwen3-4b", {"n_kv_heads": 2, "vocab_size": 500}),
    "grok-1-314b": ("grok-1-314b", {}),
    "rwkv6-1.6b": ("rwkv6-1.6b", {}),
    "hymba-1.5b": ("hymba-1.5b", {}),
    "whisper-tiny": ("whisper-tiny", {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, over):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return jcfg, cfg


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab_size,
                                    (B, S + 1)).astype(np.int32)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model),
                                              np.float32)
    elif cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), np.float32)
    return batch


def _port_value_and_grad(fn, params):
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = fn(params)
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return out, tree.unflatten(params, grads)


def _assert_grads_close(port, ref):
    """Every leaf of the port's gradient tree against the reference's
    (both as {path: array}), within GRAD_TOL of the leaf's largest |g|."""
    port = dict(tree.leaves_with_path(port))
    ref = dict(tree.leaves_with_path(ref))
    assert port.keys() == ref.keys()
    for key, g in port.items():
        want = np.asarray(ref[key], np.float32)
        got = g.detach().numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * scale, (key, err, scale)


# ------------------------------------------------------------ softmax_xent
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    V, V_real = 384, 300                        # 84 padded ids, as _logits
    logits = rng.standard_normal((3, 7, V)).astype(np.float32) * 4
    logits[..., V_real:] = -1e9
    labels = rng.integers(0, V_real, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jax_layers.softmax_xent(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = layers.softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_xent_all_masked_divides_by_one():
    logits = torch.randn(2, 3, 8)
    labels = torch.zeros(2, 3, dtype=torch.int32)
    got = layers.softmax_xent(logits, labels, torch.zeros(2, 3))
    want = jax_layers.softmax_xent(jnp.asarray(logits.numpy()),
                                   jnp.asarray(labels.numpy()),
                                   jnp.zeros((2, 3)))
    assert float(got) == float(want) == 0.0


# ------------------------------------------------------------ train_loss
@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over = CASES[request.param]
    jcfg, cfg = _configs(arch, over)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, device="cpu"), params


def test_train_loss_and_grads_match_reference(case):
    jmodel, jparams, model, params = case
    batch = _batch(model.cfg, seed=5)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss, m), grads = _port_value_and_grad(
        lambda p: model.train_loss(p, tb), params)
    loss, xent, aux = (float(t.detach()) for t in (loss, m["xent"],
                                                   m["aux"]))
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(xent, float(jm["xent"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux, float(jm["aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    if model.cfg.family == "moe":
        assert aux > 0
    ref = params_from_numpy(jax.tree.map(np.asarray, jgrads), model.cfg,
                            "cpu")
    _assert_grads_close(grads, ref)


@pytest.mark.parametrize("arch", ["qwen3-4b", "grok-1-314b", "hymba-1.5b",
                                  "whisper-tiny", "rwkv6-1.6b"])
def test_remat_gradients_equal_plain(arch):
    cfg = get_config(arch).reduced()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 6).items()}
    params = build_model(cfg, device="cpu").init(1)
    outs = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device="cpu")
        (loss, _), grads = _port_value_and_grad(
            lambda p: model.train_loss(p, batch), params)
        outs.append((loss, tree.leaves(grads)))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ------------------------------------------------------------ CV losses
def test_classifier_loss_matches_reference():
    jparams = jax_bert.init_classifier(jax.random.key(2))
    params = classifier_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((6, jax_bert.EMBED_DIM)).astype(np.float32)
    labels = rng.integers(0, jax_bert.N_SECTIONS, (6,)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jax_bert.classifier_loss(
        p, jnp.asarray(emb), jnp.asarray(labels)))(jparams)
    loss, grads = _port_value_and_grad(
        lambda p: bert_encoder.classifier_loss(
            p, torch.from_numpy(emb), torch.from_numpy(labels)), params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    _assert_grads_close(grads, jax.tree.map(np.asarray, jg))


def test_bilstm_lan_loss_matches_reference():
    jcfg = jax_lan.LANConfig(vocab_size=64, n_labels=5, d_model=32,
                             n_layers=2, n_heads=4)
    cfg = bilstm_lan.LANConfig(vocab_size=64, n_labels=5, d_model=32,
                               n_layers=2, n_heads=4)
    jparams = jax_lan.init_params(jax.random.key(3), jcfg)
    params = lan_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 64, (3, 6)).astype(np.int32)
    toks[0, 4:] = 0
    labels = rng.integers(0, 5, (3, 6)).astype(np.int32)
    mask = (toks != 0).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda p: jax_lan.loss(
        p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
        jnp.asarray(mask)))(jparams)
    loss, grads = _port_value_and_grad(
        lambda p: bilstm_lan.loss(p, cfg, torch.from_numpy(toks),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask)), params)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    _assert_grads_close(grads, jax.tree.map(np.asarray, jg))
