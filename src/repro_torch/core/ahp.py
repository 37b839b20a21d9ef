"""Analytical Hierarchy Processing (AHP; own copy of the reference's
``core/ahp.py``, numpy only): the paper's §3.1.3/§4.1 method for
selecting the serving substrate by multi-criteria decision making.

Structure: a goal, a set of criteria (pairwise-compared among themselves),
and a set of alternatives pairwise-compared w.r.t. each criterion. Each
pairwise matrix yields a priority vector (principal eigenvector, Saaty);
criteria weights combine the per-criterion priorities into final scores.

The paper's preference functions (§4.1):
    lower-is-better  (times):       pref(a1,a2) = min(9, max(1/9, a2/a1))
    higher-is-better (throughput):  pref(a1,a2) = min(9, max(1/9, a1/a2))
and all criteria weighted equally (pairwise preference 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SAATY_RI = {1: 0.0, 2: 0.0, 3: 0.58, 4: 0.90, 5: 1.12, 6: 1.24, 7: 1.32,
            8: 1.41, 9: 1.45, 10: 1.49}


def clamp_preference(x: float) -> float:
    """Saaty scale clamp used by the paper: [1/9, 9]."""
    return min(9.0, max(1.0 / 9.0, x))


def lower_is_better(a1: float, a2: float) -> float:
    return clamp_preference(a2 / a1)


def higher_is_better(a1: float, a2: float) -> float:
    return clamp_preference(a1 / a2)


def pairwise_matrix(values, pref_fn) -> np.ndarray:
    n = len(values)
    m = np.ones((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                m[i, j] = pref_fn(float(values[i]), float(values[j]))
    return m


def priority_vector(m: np.ndarray, iters: int = 200) -> np.ndarray:
    """Principal right-eigenvector by power iteration, normalized to sum 1."""
    n = m.shape[0]
    v = np.ones(n) / n
    for _ in range(iters):
        nv = m @ v
        nv = nv / nv.sum()
        if np.allclose(nv, v, rtol=1e-12, atol=1e-14):
            v = nv
            break
        v = nv
    return v


def consistency_ratio(m: np.ndarray) -> float:
    """Saaty CR = CI / RI; CR < 0.1 is conventionally acceptable."""
    n = m.shape[0]
    if n <= 2:
        return 0.0
    v = priority_vector(m)
    lam = float(np.mean((m @ v) / v))
    ci = (lam - n) / (n - 1)
    return ci / SAATY_RI.get(n, 1.49)


@dataclass
class Criterion:
    name: str
    higher_is_better: bool = True
    weight_votes: float = 1.0   # pairwise criteria preference (paper: all 1)


@dataclass
class AHPResult:
    alternatives: list
    criteria: list
    criteria_weights: np.ndarray          # (C,)
    per_criterion: np.ndarray             # (C, A) priorities
    scores: np.ndarray                    # (A,) final selection percentages
    consistency: dict = field(default_factory=dict)

    def ranking(self):
        order = np.argsort(-self.scores)
        return [(self.alternatives[i], float(self.scores[i])) for i in order]

    def table(self) -> str:
        """Markdown table in the paper's Tables 3-5 layout (criterion
        contribution per alternative)."""
        head = " | ".join(["criterion", "weight"] + list(self.alternatives))
        rows = [head, " | ".join(["---"] * (2 + len(self.alternatives)))]
        rows.append(" | ".join(
            ["TOTAL", "100%"] + [f"{s*100:.1f}%" for s in self.scores]))
        for ci, c in enumerate(self.criteria):
            contrib = self.criteria_weights[ci] * self.per_criterion[ci]
            rows.append(" | ".join(
                [c.name, f"{self.criteria_weights[ci]*100:.1f}%"]
                + [f"{x*100:.1f}%" for x in contrib]))
        return "\n".join(rows)


def run_ahp(alternatives: list, criteria: list, measurements) -> AHPResult:
    """measurements[c][a]: value of criterion c for alternative a
    (dict-of-dicts keyed by names, or a (C, A) array)."""
    C, A = len(criteria), len(alternatives)
    vals = np.zeros((C, A))
    for ci, c in enumerate(criteria):
        for ai, a in enumerate(alternatives):
            vals[ci, ai] = measurements[c.name][a] \
                if isinstance(measurements, dict) else measurements[ci][ai]

    # criteria pairwise matrix from weight votes (paper: all equal -> 1/C)
    crit_m = pairwise_matrix([c.weight_votes for c in criteria],
                             higher_is_better)
    cw = priority_vector(crit_m)

    per_c = np.zeros((C, A))
    consistency = {"criteria": consistency_ratio(crit_m)}
    for ci, c in enumerate(criteria):
        fn = higher_is_better if c.higher_is_better else lower_is_better
        m = pairwise_matrix(vals[ci], fn)
        per_c[ci] = priority_vector(m)
        consistency[c.name] = consistency_ratio(m)

    scores = cw @ per_c
    return AHPResult(list(alternatives), list(criteria), cw, per_c, scores,
                     consistency)


# ----------------------------------------------------------------- paper data
# Apache-Bench measurements from the paper's Table 2 (Verma & Prasad 2021).
PAPER_CRITERIA = [
    Criterion("Time per concurrent request", higher_is_better=False),
    Criterion("Requests per second", higher_is_better=True),
    Criterion("Time per request", higher_is_better=False),
    Criterion("Transfer rate", higher_is_better=True),
    Criterion("Total transferred", higher_is_better=True),
    Criterion("Time taken for tests", higher_is_better=False),
]

PAPER_TABLE2 = {
    "Hello World": {
        "Falcon":  {"Time per concurrent request": 23, "Requests per second": 4274,
                    "Time per request": 4, "Transfer rate": 680,
                    "Total transferred": 1_630_000, "Time taken for tests": 2},
        "FastApi": {"Time per concurrent request": 37, "Requests per second": 2650,
                    "Time per request": 7, "Transfer rate": 357,
                    "Total transferred": 1_380_000, "Time taken for tests": 3},
        "Flask":   {"Time per concurrent request": 84, "Requests per second": 1180,
                    "Time per request": 16, "Transfer rate": 190,
                    "Total transferred": 1_650_000, "Time taken for tests": 8},
    },
    "Finding value of Fibonacci": {
        "Falcon":  {"Time per concurrent request": 25, "Requests per second": 3969,
                    "Time per request": 5, "Transfer rate": 610,
                    "Total transferred": 1_730_000, "Time taken for tests": 2},
        "FastApi": {"Time per concurrent request": 38, "Requests per second": 2579,
                    "Time per request": 7, "Transfer rate": 372,
                    "Total transferred": 1_480_000, "Time taken for tests": 3},
        "Flask":   {"Time per concurrent request": 88, "Requests per second": 1126,
                    "Time per request": 17, "Transfer rate": 192,
                    "Total transferred": 1_750_000, "Time taken for tests": 8},
    },
    "File retrival from database": {
        "Falcon":  {"Time per concurrent request": 701, "Requests per second": 142,
                    "Time per request": 140, "Transfer rate": 22,
                    "Total transferred": 1_600_000, "Time taken for tests": 70},
        "FastApi": {"Time per concurrent request": 693, "Requests per second": 144,
                    "Time per request": 138, "Transfer rate": 19,
                    "Total transferred": 1_360_000, "Time taken for tests": 69},
        "Flask":   {"Time per concurrent request": 729, "Requests per second": 137,
                    "Time per request": 145, "Transfer rate": 21,
                    "Total transferred": 1_620_000, "Time taken for tests": 72},
    },
}

# Selection percentages the paper reports (Tables 3, 4, 5).
PAPER_RESULTS = {
    "Hello World": {"Falcon": 0.505, "FastApi": 0.317, "Flask": 0.178},
    "Finding value of Fibonacci": {"Falcon": 0.491, "FastApi": 0.330,
                                   "Flask": 0.179},
    "File retrival from database": {"Falcon": 0.341, "Flask": 0.332,
                                    "FastApi": 0.327},
}


def reproduce_paper_tables() -> dict:
    """Run AHP on the paper's own Table 2 -> per-scenario AHPResult."""
    out = {}
    for scenario, alt_vals in PAPER_TABLE2.items():
        alts = list(alt_vals)
        meas = {c.name: {a: alt_vals[a][c.name] for a in alts}
                for c in PAPER_CRITERIA}
        out[scenario] = run_ahp(alts, PAPER_CRITERIA, meas)
    return out
