"""The one traffic generator: it reads a mix's parameters (a
``traffic/<mix>.json`` file) and turns them, with a seed, into requests.

Every seed gets the same multiset of sizes and gaps, in another order:
lengths and inter-arrival gaps are the quantiles of their distributions
at evenly spaced probabilities, shuffled by the seed, so two seeds differ
in which request is long and when, never in how much work a window holds.
Prompt token ids are drawn from the seed and share nothing.

Open loop (``"loop": "open"``): arrivals at ``rate_rps`` with exponential
gaps, due times relative to the window's start, from ``-preroll_s`` (not
measured: it fills the engine) to the window's end.

Closed loop (``"loop": "closed"``): ``clients`` callers, each sending its
next request when the last one finished, from a stream of requests drawn
in blocks of ``BLOCK`` that each hold the same sizes. Each client's first
request has its output cut to a share of its length, so that the window
opens on requests at every stage of their output, as in a running system.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

BLOCK = 256


@dataclass
class Spec:
    """One request: ``due`` seconds after the window opens (open loop;
    None in a closed loop), its prompt ids and its output length."""
    index: int
    prompt: list
    max_new: int
    due: float | None = None


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` integer sizes at probabilities (i + 1/2) / n of ``dist``:
    ``{"dist": "uniform" | "loguniform", "min", "max"}`` (both ends
    included)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def _prompts(mix: dict, seed: int, lengths, vocab: int) -> list:
    rng = _rng(seed, 3)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lengths]


def _phase(mix: dict, seed: int, n: int, stream: int):
    """n exponential gaps and n (prompt, output) lengths, each the same
    quantiles for every seed, shuffled by it."""
    rate = float(mix["rate_rps"])
    u = (np.arange(n) + 0.5) / n
    gaps = _rng(seed, stream).permutation(-np.log1p(-u) / rate)
    plen = _rng(seed, stream + 1).permutation(quantiles(mix["prompt"], n))
    olen = _rng(seed, stream + 2).permutation(quantiles(mix["output"], n))
    return gaps, plen, olen


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    """The requests due in the window ``[0, seconds)`` (the same count
    for every seed: ``rate_rps x seconds``), after those of the preroll,
    due from ``-preroll_s`` up to the window's first; in due order."""
    rate = float(mix["rate_rps"])
    n_w = max(1, round(rate * float(seconds)))
    n_p = round(rate * float(mix.get("preroll_s", 0.0)))
    gw, pw, ow = _phase(mix, seed, n_w, 20)
    due_w = np.cumsum(gw) - gw[0]
    gp, pp, op = _phase(mix, seed, n_p, 30)
    due_p = -np.cumsum(gp)[::-1]
    due = np.concatenate([due_p, due_w])
    plen = np.concatenate([pp[::-1], pw])
    olen = np.concatenate([op[::-1], ow])
    prompts = _prompts(mix, seed, plen, vocab)
    return [Spec(i, prompts[i], int(olen[i]), float(due[i]))
            for i in range(len(due))]


class ClosedStream:
    """The request stream a closed loop's clients draw from, in order."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        self.n = 0
        self._block: list = []

    def _fill(self) -> None:
        b = self.n // BLOCK
        plen = _rng(self.seed, 10 + 2 * b).permutation(
            quantiles(self.mix["prompt"], BLOCK))
        olen = _rng(self.seed, 11 + 2 * b).permutation(
            quantiles(self.mix["output"], BLOCK))
        rng = _rng(self.seed, 1_000_000 + b)
        self._block = [(rng.integers(0, self.vocab, int(p)).tolist(), int(o))
                       for p, o in zip(plen, olen)]

    def next(self) -> Spec:
        if self.n % BLOCK == 0:
            self._fill()
        prompt, max_new = self._block[self.n % BLOCK]
        spec = Spec(self.n, prompt, max_new)
        self.n += 1
        return spec

    def first(self, clients: int) -> list:
        """Each client's first request, its output cut to the share
        (i + 1/2) / clients of its length, the shares shuffled."""
        share = _rng(self.seed, 4).permutation(
            (np.arange(clients) + 0.5) / clients)
        out = []
        for c in range(clients):
            s = self.next()
            s.max_new = max(1, int(math.ceil(s.max_new * share[c])))
            out.append(s)
        return out
