"""The port's sampler against ``repro.serve.sampling`` and ``jax.random``
on the CPU.

The PRNG (``repro_torch.serve.prng``) reproduces jax 0.9's default
threefry2x32 with ``jax_threefry_partitionable`` on: key data after
``fold_in``, ``jax.random.bits`` and ``jax.random.uniform`` are
bit-exact for seeds 0, 1, -1 and 2**31-1 at widths 1, 7, 1000 and
151,936 (qwen3-4b's vocabulary). ``sample``, ``draft_propose`` and
``speculative_accept`` take the same numpy inputs as the reference:
tokens and ``accepted`` identical, logprobs / probs within
atol = rtol = 1e-6 up to V 1000 (one float32 ulp of a logprob near -10
is 9.5e-7; the two frameworks' exp / log differ in the last bit). At
V 151,936 the log-sum-exp adds 151,936 float32 terms in another order
than XLA does, which moves a logprob by up to a few 1e-6 (7.4e-6 seen):
there the engine's 2e-5 holds. The second half
mirrors each case of ``tests/test_sampling.py`` on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as ref
from repro_torch.serve import prng
from repro_torch.serve import sampling
from repro_torch.serve.sampling import (GREEDY, SamplingParams,
                                        draft_propose, sample,
                                        speculative_accept)

SEEDS = [0, 1, -1, 2**31 - 1]
TOL = dict(atol=1e-6, rtol=1e-6)
WIDE_TOL = dict(atol=2e-5, rtol=2e-5)     # V 151,936: sum order


def test_jax_threefry_is_partitionable():
    """The stream the port reproduces; a flip of this flag changes the
    reference's bits and must fail here, not in a token comparison."""
    assert jax.config.jax_threefry_partitionable is True


def _jkey(seed, stream=0, ctr=5):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                 stream), ctr)


@pytest.mark.parametrize("V", [1, 7, 1000, 151936])
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_and_uniform_bit_exact(seed, V):
    k = _jkey(seed)
    hk = sampling.stream_keys(np.int32(seed), np.int64(5), 0)
    assert [int(hk[0]), int(hk[1])] == \
        np.asarray(jax.random.key_data(k)).tolist()
    k0, k1 = (torch.tensor([int(w)]) for w in hk)
    got = prng.bits(k0, k1, V)[0]
    want = np.asarray(jax.random.bits(k, (V,))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    for lo, hi in ((float(np.finfo(np.float32).tiny), 1.0), (0.0, 1.0)):
        u = prng.uniform(got, lo, hi).numpy()
        ju = np.asarray(jax.random.uniform(k, (V,), minval=lo, maxval=hi))
        np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    lg = np.random.default_rng(seed % 97).standard_normal(
        (3, 1000)).astype(np.float32) * 3
    hk = sampling.stream_keys(np.full(3, seed, np.int32), np.arange(3), 0)
    got = prng.categorical(torch.as_tensor(hk[0]), torch.as_tensor(hk[1]),
                           torch.as_tensor(lg))
    want = [int(jax.random.categorical(_jkey(seed, 0, c), jnp.asarray(row)))
            for c, row in enumerate(lg)]
    assert got.tolist() == want


# ------------------------------------------------ against the reference
def _rows_np(B, temps, top_ks, seeds, ctrs=None):
    return (np.asarray(temps, np.float32), np.asarray(top_ks, np.int32),
            np.asarray(seeds, np.int32),
            np.arange(B, dtype=np.int32) if ctrs is None
            else np.asarray(ctrs, np.int32))


def _logits(B, V, seed, ties=False):
    lg = np.random.default_rng(seed).standard_normal((B, V)).astype(
        np.float32) * 3
    if ties:                        # ten-way tie at the top of each row
        lg[:, :10] = lg.max(-1, keepdims=True) + 1
        lg[:, 20:30] = lg[:, 10:20].max(-1, keepdims=True)
    return lg


SAMPLE_CASES = {
    "greedy": (4, 33, ([0.0] * 4, [0] * 4, SEEDS)),
    "sampled": (4, 50, ([0.9, 0.3, 1.0, 1.5], [0] * 4, SEEDS)),
    "top_k_ties": (4, 64, ([1.0, 1.5, 0.7, 2.0], [1, 5, 12, 25], SEEDS)),
    "mixed_wide": (8, 151936, ([0.0, 0.3, 1.0, 1.5, 0.0, 0.3, 1.0, 1.5],
                               [0, 1, 50, 0, 50, 0, 1, 50], SEEDS * 2)),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_matches_reference(case):
    B, V, knobs = SAMPLE_CASES[case]
    lg = _logits(B, V, seed=B + V, ties=case == "top_k_ties")
    rows = _rows_np(B, *knobs)
    jt, jl = ref.sample(jnp.asarray(lg), *map(jnp.asarray, rows))
    pt, pl = sample(torch.as_tensor(lg), *rows)
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                               **(WIDE_TOL if V > 1000 else TOL))


def test_draft_propose_matches_reference():
    B, V = 8, 1000
    lg = _logits(B, V, seed=4)
    rows = _rows_np(B, [0.0, 0.3, 1.0, 1.5] * 2, [0, 1, 50, 0] * 2,
                    SEEDS * 2)
    pos = np.asarray([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
    jt, jp = ref.draft_propose(jnp.asarray(lg), *map(jnp.asarray, rows),
                               jnp.asarray(pos))
    pt, pp = draft_propose(torch.as_tensor(lg), *rows, pos)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), **TOL)


def _accept_inputs(B, S, V, seed):
    rng = np.random.default_rng(seed)
    tl = (rng.standard_normal((B, S, V)) * 2).astype(np.float32)
    dl = rng.standard_normal((B, S - 1, V)).astype(np.float32)
    dp = np.array(jax.nn.softmax(jnp.asarray(dl), -1))
    prop = tl[:, :S - 1].argmax(-1).astype(np.int32)
    return tl, dp, prop


ACCEPT_CASES = {
    # greedy rows: leading argmax matches, a divergence at position 1
    "greedy": dict(temps=[0.0] * 4, n_spec=[3, 3, 2, 3], diverge=True),
    # sampled rows, with and without top-k
    "sampled": dict(temps=[0.7, 1.0, 1.5, 0.3], n_spec=[3, 3, 3, 2],
                    top_ks=[0, 5, 0, 50]),
    # n_spec 0: a rider gets the token-stream draw back
    "rider": dict(temps=[0.0, 0.8, 1.2, 0.0], n_spec=[0, 0, 0, 3]),
    # proposals the target gives ~zero mass: rejected, residual drawn
    "rejection": dict(temps=[1.0, 0.7, 1.3, 0.0], n_spec=[3] * 4,
                      reject=True),
}


@pytest.mark.parametrize("case", list(ACCEPT_CASES))
def test_speculative_accept_matches_reference(case):
    c = ACCEPT_CASES[case]
    B, S, V = 4, 4, 1000
    tl, dp, prop = _accept_inputs(B, S, V, seed=len(case))
    if c.get("diverge"):
        prop[::2, 1] = (prop[::2, 1] + 1) % V
    if c.get("reject"):
        prop[:] = 7
        tl[:, :, 7] = -30.0
        dp[:, :, :] = 1e-6
        dp[:, :, 7] = 1.0
    rows = _rows_np(B, c["temps"], c.get("top_ks", [0] * B), SEEDS,
                    ctrs=[3, 0, 9, 1])
    ns = np.asarray(c["n_spec"], np.int32)
    ja, jt, jl = ref.speculative_accept(
        jnp.asarray(tl), jnp.asarray(dp), jnp.asarray(prop),
        jnp.asarray(ns), *map(jnp.asarray, rows))
    pa, pt, pl = speculative_accept(torch.as_tensor(tl),
                                    torch.as_tensor(dp), prop, ns, *rows)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    if case == "rider":
        assert pa.numpy()[:3].tolist() == [0, 0, 0]
    if case == "rejection":
        assert (pa.numpy() == 0).all() and 7 not in pt.numpy()[:, 0]


# ---------------------------------- tests/test_sampling.py on the port
def _plogits(B, V, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (B, V)).astype(np.float32) * 3.0)


def _rows(n, temp=0.0, top_k=0, seed=0, ctr=0):
    return (np.full(n, temp, np.float32), np.full(n, top_k, np.int32),
            np.full(n, seed, np.int32), np.full(n, ctr, np.int32))


def test_greedy_is_argmax_with_logprob():
    lg = _plogits(4, 33)
    toks, lps = sample(lg, *_rows(4))
    assert toks.tolist() == torch.argmax(lg, -1).tolist()
    expect = torch.log_softmax(lg, -1)[torch.arange(4), toks.long()]
    np.testing.assert_allclose(lps.numpy(), expect.numpy(), rtol=1e-6)


def test_sampled_deterministic_per_seed_and_counter():
    lg = _plogits(2, 50)
    a, _ = sample(lg, *_rows(2, temp=0.9, seed=7, ctr=3))
    b, _ = sample(lg, *_rows(2, temp=0.9, seed=7, ctr=3))
    assert a.tolist() == b.tolist()
    diff = False
    for ctr in range(6):
        x, _ = sample(lg, *_rows(2, temp=0.9, seed=7, ctr=ctr))
        y, _ = sample(lg, *_rows(2, temp=0.9, seed=8, ctr=ctr))
        diff |= x.tolist() != y.tolist()
    assert diff


def test_top_k_restricts_support():
    lg = _plogits(1, 64, seed=3)
    order = torch.argsort(lg[0], descending=True)
    allowed = set(order[:5].tolist())
    for ctr in range(20):
        (tok,), _ = sample(lg, *_rows(1, temp=1.5, top_k=5, ctr=ctr))
        assert int(tok) in allowed
    (tok,), _ = sample(lg, *_rows(1, temp=5.0, top_k=1, ctr=9))
    assert int(tok) == int(order[0])


def test_logprob_is_raw_model_logprob_even_when_shaped():
    lg = _plogits(1, 40, seed=5)
    (tok,), (lp,) = sample(lg, *_rows(1, temp=2.0, top_k=3, ctr=1))
    want = torch.log_softmax(lg[0], -1)[int(tok)]
    assert float(lp) == pytest.approx(float(want), rel=1e-6)


def test_draft_propose_greedy_and_probs_shape():
    lg = _plogits(3, 20, seed=9)
    toks, probs = draft_propose(lg, *_rows(3), np.zeros(3, np.int32))
    assert toks.tolist() == torch.argmax(lg, -1).tolist()
    assert tuple(probs.shape) == (3, 20)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def _accept(tlogits, dprobs, proposed, n_spec, temp=0.0, seed=0, ctr=0):
    B = tlogits.shape[0]
    return speculative_accept(tlogits, dprobs, np.asarray(proposed),
                              np.asarray(n_spec),
                              *_rows(B, temp=temp, seed=seed, ctr=ctr))


def _tlogits(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_greedy_accept_counts_leading_argmax_matches():
    V, k = 17, 3
    tl = _tlogits((1, k + 1, V), 2)
    am = torch.argmax(tl, -1)[0].tolist()
    dp = torch.full((1, k, V), 1.0 / V)
    a, toks, lps = _accept(tl, dp, [[am[0], (am[1] + 1) % V, am[2]]], [k])
    assert int(a[0]) == 1
    assert toks[0, :2].tolist() == [am[0], am[1]]
    want = torch.log_softmax(tl[0, 1], -1)[am[1]]
    assert float(lps[0, 1]) == pytest.approx(float(want), rel=1e-6)


def test_greedy_accept_all_plus_bonus():
    V, k = 11, 2
    tl = _tlogits((1, k + 1, V), 4)
    am = torch.argmax(tl, -1)[0].tolist()
    dp = torch.full((1, k, V), 1.0 / V)
    a, toks, _ = _accept(tl, dp, [am[:2]], [k])
    assert int(a[0]) == k
    assert toks[0].tolist() == am


def test_rider_row_gets_exactly_the_bonus():
    V, k = 9, 3
    tl = _tlogits((1, k + 1, V), 6)
    dp = torch.full((1, k, V), 1.0 / V)
    a, toks, _ = _accept(tl, dp, [[1, 2, 3]], [0])
    assert int(a[0]) == 0
    assert int(toks[0, 0]) == int(torch.argmax(tl[0, 0]))


def test_sampled_accept_identical_dists_accepts_everything():
    V, k = 23, 3
    tl = _tlogits((2, k + 1, V), 8) * 2.0
    temp = 0.7
    shaped = sampling._shaped(tl.reshape(-1, V), torch.full((2 * (k + 1),),
                                                            temp), None, 0)
    probs = torch.softmax(shaped, -1).reshape(2, k + 1, V)
    proposed = torch.argmax(probs[:, :k], -1).numpy()
    a, _, _ = _accept(tl, probs[:, :k], proposed, [k, k], temp=temp, seed=3,
                      ctr=1)
    assert a.tolist() == [k, k]


def test_sampled_accept_zero_prob_proposal_rejected():
    V, k = 12, 2
    tl = torch.zeros((1, k + 1, V))
    tl[:, :, 4] = 9.0
    dp = torch.full((1, k, V), 1e-6)
    dp[:, :, 7] = 1.0
    a, toks, _ = _accept(tl, dp, [[7, 7]], [k], temp=1.0, seed=5, ctr=2)
    assert int(a[0]) == 0
    assert int(toks[0, 0]) == 4


def test_sampling_params_defaults():
    assert GREEDY.greedy and GREEDY.temperature == 0.0
    assert not SamplingParams(temperature=0.5).greedy


def test_all_greedy_rows_stage_nothing():
    """An all-greedy batch copies no sampling tensor to the device and
    draws no bits; one sampled row stages the keys."""
    rows = sampling.Rows(*_rows(3), "cpu")
    assert not rows.sampled and not hasattr(rows, "k0")
    rows = sampling.Rows(np.asarray([0.0, 0.5, 0.0], np.float32),
                         *_rows(3)[1:], "cpu")
    assert rows.sampled and tuple(rows.k0.shape) == (3,)
