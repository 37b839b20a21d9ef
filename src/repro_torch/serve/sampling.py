"""Token sampling for the serving engine.

:class:`SamplingParams` keeps the reference's three knobs per request
(``temperature``, ``top_k``, ``seed``). This slice samples greedily:
first-index argmax, with the raw ``log_softmax`` logprob of the chosen
token in float32 streamed beside it. A row with ``temperature > 0``
raises: its draws come from ``jax.random`` threefry keys in the
reference, and reproducing them in torch is the "sampled rows" slice of
ROADMAP.md.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. The default is greedy argmax."""
    temperature: float = 0.0
    top_k: int = 0                 # 0 = full vocabulary
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()

SAMPLED_LATER = ("sampled decoding (temperature > 0) needs the reference's "
                  "threefry / categorical draws in torch: the 'sampled rows' "
                  "slice of ROADMAP.md")


def sample(logits, temps, top_ks, seeds, ctrs):
    """Batched sampling: logits (B, V) on the device; temps / top_ks /
    seeds / ctrs (B,) host arrays. Returns (tokens (B,) int32, logprobs
    (B,) f32) on the logits' device — greedy only."""
    if np.any(np.asarray(temps) > 0.0):
        raise NotImplementedError(SAMPLED_LATER)
    logits = logits.float()
    tok = torch.argmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok.to(torch.int32), logp
