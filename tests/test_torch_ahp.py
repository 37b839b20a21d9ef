"""The port's AHP (``repro_torch.core.ahp``, numpy only): each case of
``tests/test_ahp.py`` on the port — the paper's Tables 3-5 and the
algebraic properties — and ``run_ahp`` / ``reproduce_paper_tables``
equal to the reference's, number for number."""
import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic local shim, see requirements-dev
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core import ahp as jahp
from repro_torch.core import ahp


# ------------------------------------------------------ paper reproduction
def test_reproduces_paper_table3_hello_world_exactly():
    res = ahp.reproduce_paper_tables()["Hello World"]
    got = dict(zip(res.alternatives, res.scores))
    assert got["Falcon"] == pytest.approx(0.505, abs=0.002)
    assert got["FastApi"] == pytest.approx(0.317, abs=0.002)
    assert got["Flask"] == pytest.approx(0.178, abs=0.002)


def test_reproduces_paper_table4_fibonacci():
    # paper's Table 2 inputs are rounded to integers -> 1pp tolerance
    res = ahp.reproduce_paper_tables()["Finding value of Fibonacci"]
    got = dict(zip(res.alternatives, res.scores))
    for name, want in ahp.PAPER_RESULTS["Finding value of Fibonacci"].items():
        assert got[name] == pytest.approx(want, abs=0.01)


def test_reproduces_paper_table5_file_retrieval_ranking():
    res = ahp.reproduce_paper_tables()["File retrival from database"]
    got = dict(zip(res.alternatives, res.scores))
    for name, want in ahp.PAPER_RESULTS["File retrival from database"].items():
        assert got[name] == pytest.approx(want, abs=0.005)
    assert max(got, key=got.get) == "Falcon"


def test_falcon_wins_all_scenarios():
    for scenario, res in ahp.reproduce_paper_tables().items():
        assert res.ranking()[0][0] == "Falcon", scenario


def test_criteria_weights_equal_when_unpreferred():
    res = ahp.reproduce_paper_tables()["Hello World"]
    np.testing.assert_allclose(res.criteria_weights, 1 / 6, atol=1e-9)


def _same_result(res, jres):
    assert res.alternatives == jres.alternatives
    assert [c.name for c in res.criteria] == [c.name for c in jres.criteria]
    for f in ("criteria_weights", "per_criterion", "scores"):
        np.testing.assert_array_equal(getattr(res, f), getattr(jres, f))
    assert res.consistency == jres.consistency
    assert res.table() == jres.table()
    assert res.ranking() == jres.ranking()


def test_paper_tables_equal_reference():
    mine, ref = ahp.reproduce_paper_tables(), jahp.reproduce_paper_tables()
    assert list(mine) == list(ref)
    for scenario in ref:
        _same_result(mine[scenario], ref[scenario])
    assert ahp.PAPER_TABLE2 == jahp.PAPER_TABLE2
    assert ahp.PAPER_RESULTS == jahp.PAPER_RESULTS


# ------------------------------------------------------------- properties
@st.composite
def measurements(draw, n_alts=3, n_crit=3):
    vals = draw(st.lists(
        st.lists(st.floats(min_value=0.1, max_value=1e4,
                           allow_nan=False, allow_infinity=False),
                 min_size=n_alts, max_size=n_alts),
        min_size=n_crit, max_size=n_crit))
    return np.array(vals)


@settings(max_examples=30, deadline=None)
@given(measurements())
def test_scores_are_a_distribution(vals):
    crit = [ahp.Criterion(f"c{i}", higher_is_better=bool(i % 2))
            for i in range(vals.shape[0])]
    alts = [f"a{i}" for i in range(vals.shape[1])]
    res = ahp.run_ahp(alts, crit, vals)
    assert np.all(res.scores >= -1e-12)
    assert np.isclose(res.scores.sum(), 1.0, atol=1e-9)


@settings(max_examples=30, deadline=None)
@given(measurements())
def test_run_ahp_equals_reference(vals):
    crit = [(f"c{i}", bool(i % 2), 1.0 + i) for i in range(vals.shape[0])]
    alts = [f"a{i}" for i in range(vals.shape[1])]
    res = ahp.run_ahp(alts, [ahp.Criterion(*c) for c in crit], vals)
    jres = jahp.run_ahp(alts, [jahp.Criterion(*c) for c in crit], vals)
    _same_result(res, jres)


@settings(max_examples=30, deadline=None)
@given(measurements(), st.floats(min_value=0.5, max_value=100.0))
def test_scale_invariance(vals, scale):
    """Ratio-based preferences are invariant to rescaling a criterion
    (until the 1/9..9 clamp binds identically)."""
    crit = [ahp.Criterion(f"c{i}") for i in range(vals.shape[0])]
    alts = [f"a{i}" for i in range(vals.shape[1])]
    r1 = ahp.run_ahp(alts, crit, vals)
    r2 = ahp.run_ahp(alts, crit, vals * scale)
    np.testing.assert_allclose(r1.scores, r2.scores, atol=1e-9)


@settings(max_examples=30, deadline=None)
@given(measurements())
def test_permutation_equivariance(vals):
    crit = [ahp.Criterion(f"c{i}") for i in range(vals.shape[0])]
    alts = ["a0", "a1", "a2"]
    perm = [2, 0, 1]
    r1 = ahp.run_ahp(alts, crit, vals)
    r2 = ahp.run_ahp([alts[p] for p in perm], crit, vals[:, perm])
    np.testing.assert_allclose(r1.scores[perm], r2.scores, atol=1e-9)


def test_dominant_alternative_wins():
    vals = np.array([[10.0, 1.0, 1.0], [20.0, 2.0, 1.0]])
    crit = [ahp.Criterion("t", higher_is_better=True),
            ahp.Criterion("u", higher_is_better=True)]
    res = ahp.run_ahp(["best", "mid", "worst"], crit, vals)
    assert res.ranking()[0][0] == "best"
    assert res.ranking()[-1][0] == "worst"


def test_consistency_ratio_of_consistent_matrix_is_zero():
    m = ahp.pairwise_matrix([1.0, 2.0, 4.0], ahp.higher_is_better)
    assert ahp.consistency_ratio(m) < 1e-6
