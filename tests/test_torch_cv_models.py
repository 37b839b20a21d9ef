"""The CV parser's models in the port against the JAX reference on the
CPU, at the real widths: the sentence encoder (d 768, 12 heads of 64,
d_ff 3072, gelu, learned positions; 2 of its 4 layers where the runtime
matters), the paper's section classifier (768 -> 200 -> 4, 154,604
params) and the Bi-LSTM-LAN NER model (d 128, 2 layers, 4 heads).

Both sides run the reference's weights (carried over through numpy by
the port's converters) on the same numpy inputs, in f32. Tolerances:
encoder embeddings 1e-4 (four 768-wide layers of sum-order noise), the
classifier and every LAN output 1e-5; labels are argmaxes and must be
equal. On the CPU the encoder's non-causal attention takes the plain
masked softmax, the flash kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import bert_encoder as jbert
from repro.models import bilstm_lan as jlan
from repro_torch.models import attention, bert_encoder, bilstm_lan
from repro_torch.weights import (classifier_params_from_numpy,
                                 encoder_params_from_numpy,
                                 lan_params_from_numpy)

ENC_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(B, S, seed, pad=True):
    """(B, S) int32 ids in [2, VOCAB); with ``pad`` row b ends in b % S
    zeros (padding), the first row unpadded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, (B, S), dtype=np.int32)
    if pad:
        for b in range(B):
            n = b % S
            if n:
                ids[b, S - n:] = 0
    return ids


# ---------------------------------------------------------------- encoder
@pytest.fixture(scope="module")
def encoder():
    jcfg = dataclasses.replace(jbert.encoder_config(VOCAB), n_layers=2)
    cfg = dataclasses.replace(bert_encoder.encoder_config(VOCAB), n_layers=2)
    jp = jbert.init_encoder(jax.random.key(3), jcfg)
    return jcfg, jp, cfg, encoder_params_from_numpy(_np_tree(jp), cfg, "cpu")


@pytest.mark.parametrize("masked", [True, False])
def test_encode_sentences_matches_reference(encoder, masked):
    jcfg, jp, cfg, p = encoder
    ids = _tokens(8, 24, seed=1)
    mask = ids != 0
    want = jbert.encode_sentences(jp, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask) if masked else None)
    got = bert_encoder.encode_sentences(
        p, cfg, torch.from_numpy(ids),
        torch.from_numpy(mask) if masked else None)
    assert got.shape == (8, bert_encoder.EMBED_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


def test_encoder_config_and_tree_match_reference():
    """Full depth: the same config fields and the same leaf shapes (the
    converter checks each against the port's own init)."""
    jcfg, cfg = jbert.encoder_config(VOCAB), bert_encoder.encoder_config(VOCAB)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "act", "rope", "norm_eps"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    tree = jax.eval_shape(lambda: jbert.init_encoder(jax.random.key(0),
                                                     jcfg))
    port = bert_encoder.init_encoder(None, cfg, "meta")
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == \
        jax.tree.map(lambda t: tuple(t.shape), port,
                     is_leaf=lambda t: isinstance(t, torch.Tensor))
    n = sum(t.numel() for t in jax.tree.leaves(
        port, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert 30e6 < n < 35e6, n


def test_learned_positions_rotate_nothing(encoder):
    """``rope="learned"``: qkv projects and rotates nothing (the position
    table is added at the embedding); mrope rotates q and k by its ids."""
    _, _, cfg, p = encoder
    bp = {k: v[0] for k, v in p["blocks"]["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, cfg.d_model), np.float32))
    q, k, v = attention.qkv(x, bp, cfg)
    q0, k0, v0 = attention.qkv(x, bp, dataclasses.replace(cfg, rope="none"))
    for a, b in ((q, q0), (k, k0), (v, v0)):
        assert torch.equal(a, b)
    assert torch.equal(q, (x @ bp["w_q"]).reshape(2, 5, 12, 64))
    ids = torch.arange(5)[None, None].expand(2, 3, 5)
    qm, km, vm = attention.qkv(x, bp, dataclasses.replace(cfg, rope="mrope"),
                               mrope_positions=ids)
    assert not torch.equal(qm, q0) and not torch.equal(km, k0)
    assert torch.equal(vm, v0)
    torch.testing.assert_close(qm[:, :1], q0[:, :1])    # id 0: no turn


# ------------------------------------------------------------- classifier
def test_classify_sections_matches_reference():
    jp = jbert.init_classifier(jax.random.key(4))
    p = classifier_params_from_numpy(_np_tree(jp), "cpu")
    assert bert_encoder.classifier_n_params(p) == 154_604
    assert bert_encoder.classifier_n_params(
        bert_encoder.init_classifier(torch.Generator().manual_seed(0),
                                     "cpu")) == 154_604
    emb = np.random.default_rng(2).standard_normal((16, 768), np.float32)
    want = np.asarray(jbert.classify_sections(jp, jnp.asarray(emb)))
    got = bert_encoder.classify_sections(p, torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# -------------------------------------------------------------------- LAN
@pytest.fixture(scope="module", params=[5, 2])
def lan(request):
    jcfg = jlan.LANConfig(vocab_size=VOCAB, n_labels=request.param)
    cfg = bilstm_lan.LANConfig(vocab_size=VOCAB, n_labels=request.param)
    jp = jlan.init_params(jax.random.key(request.param), jcfg)
    return jcfg, jp, cfg, lan_params_from_numpy(_np_tree(jp), cfg, "cpu")


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d),
                                                       np.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_lstm_scan_matches_reference(lan, layer, reverse):
    _, jp, _, p = lan
    jl, tl = jp["lan_layers"][layer]["fwd"], p["lan_layers"][layer]["fwd"]
    x = _x(4, 24, tl["w"].shape[0], seed=layer)
    # a non-zero bias, so its place in the sum is checked
    b = np.random.default_rng(9).standard_normal(tl["b"].shape, np.float32)
    want = jlan.lstm_scan(dict(jl, b=jnp.asarray(b)), jnp.asarray(x),
                          reverse=reverse)
    got = bilstm_lan.lstm_scan(dict(tl, b=torch.from_numpy(b)),
                               torch.from_numpy(x), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bilstm_and_label_attention_match_reference(lan):
    jcfg, jp, cfg, p = lan
    x = _x(4, 24, cfg.d_model, seed=3)
    jl, tl = jp["lan_layers"][0], p["lan_layers"][0]
    want_h = jlan.bilstm(jl, jnp.asarray(x))
    got_h = bilstm_lan.bilstm(tl, torch.from_numpy(x))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    h = _x(4, 24, cfg.d_model, seed=4)
    want = jlan.label_attention(jnp.asarray(h), jp["label_embed"], jl,
                                jcfg.n_heads)
    got = bilstm_lan.label_attention(torch.from_numpy(h), p["label_embed"],
                                     tl, cfg.n_heads)
    assert got[1].shape == (4, 24, cfg.n_labels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_forward_and_predict_match_reference(lan):
    jcfg, jp, cfg, p = lan
    ids = _tokens(8, 24, seed=5)
    want = np.asarray(jlan.forward(jp, jcfg, jnp.asarray(ids)))
    got = bilstm_lan.forward(p, cfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    labels = bilstm_lan.predict(p, cfg, torch.from_numpy(ids)).numpy()
    jlabels = np.asarray(jlan.predict(jp, jcfg, jnp.asarray(ids)))
    if not np.array_equal(labels, jlabels):
        top2 = np.sort(want, axis=-1)[..., -2:]
        bad = labels != jlabels
        pytest.fail(f"{bad.sum()} labels differ; reference logit margins "
                    f"there: {(top2[..., 1] - top2[..., 0])[bad]}")


# ------------------------------------------------------------- converters
def _lan_tree():
    return _np_tree(jlan.init_params(jax.random.key(0),
                                     jlan.LANConfig(vocab_size=VOCAB,
                                                    n_labels=4)))


CONVERTERS = {
    "encoder": (lambda: _np_tree(jbert.init_encoder(
        jax.random.key(0), dataclasses.replace(jbert.encoder_config(VOCAB),
                                               n_layers=1))),
        lambda t: encoder_params_from_numpy(
            t, dataclasses.replace(bert_encoder.encoder_config(VOCAB),
                                   n_layers=1), "cpu"),
        ("final_norm",), ("blocks", "attn", "w_q")),
    "classifier": (lambda: _np_tree(jbert.init_classifier(jax.random.key(0))),
                   lambda t: classifier_params_from_numpy(t, "cpu"),
                   ("dense_2", "b"), ("dense_1", "w")),
    "lan": (_lan_tree,
            lambda t: lan_params_from_numpy(
                t, bilstm_lan.LANConfig(vocab_size=VOCAB, n_labels=4),
                "cpu"),
            ("lan_layers", 1, "bwd", "u"), ("lan_layers", 0, "w_q")),
}


def _pop(tree, path):
    node = tree
    for key in path[:-1]:
        node = node[key]
    return node, path[-1]


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_converters_are_leafwise_and_strict(name):
    make, convert, drop, reshape = CONVERTERS[name]
    tree = make()
    p = convert(tree)
    node, key = _pop(p, reshape)
    src, _ = _pop(tree, reshape)
    np.testing.assert_array_equal(node[key].numpy(), src[key])
    assert node[key].dtype == torch.float32
    extra = make()
    extra["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        convert(extra)
    missing = make()
    node, key = _pop(missing, drop)
    del node[key]
    with pytest.raises(ValueError, match="missing"):
        convert(missing)
    bad = make()
    node, key = _pop(bad, reshape)
    node[key] = node[key][..., :-1]
    path = "/".join(str(k) for k in reshape)
    with pytest.raises(ValueError, match=path):
        convert(bad)
