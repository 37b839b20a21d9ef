"""Synthetic LM data pipeline: document stream -> tokenize -> pack ->
batch (port of the reference's ``train/data.py`` on the port's own
``core/cvdata``).

Deterministic and seekable (resume from a step counter). The CV corpus
doubles as the document source, so training runs on the paper's domain.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import cvdata


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    batch_size: int = 8
    seed: int = 0
    n_documents: int = 512


class PackedLMDataset:
    """Greedy sequence packing with EOS separators (no padding waste)."""

    EOS = 1

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        tok = cvdata.HashTokenizer(cfg.vocab_size)
        docs = cvdata.make_corpus(cfg.n_documents, seed=cfg.seed)
        stream: list[int] = []
        for d in docs:
            for s in d.sentences:
                stream.extend(tok.encode(s.tokens))
            stream.append(self.EOS)
        self.stream = np.asarray(stream, np.int32)

    def n_tokens(self) -> int:
        return len(self.stream)

    def batch(self, step: int) -> dict:
        """Deterministic batch for a global step (seekable resume):
        {"tokens": (batch_size, seq_len + 1) int32 numpy}."""
        c = self.cfg
        span = c.seq_len + 1
        need = c.batch_size * span
        start = (step * need) % max(len(self.stream) - need, 1)
        flat = self.stream[start:start + need]
        if len(flat) < need:
            flat = np.concatenate([flat, self.stream[: need - len(flat)]])
        return {"tokens": flat.reshape(c.batch_size, span)}

    def batches(self, n_steps: int, start_step: int = 0):
        for s in range(start_step, start_step + n_steps):
            yield self.batch(s)


def sharded_batches(dataset: PackedLMDataset, plan, n_steps: int,
                    start_step: int = 0, *, device="cuda"):
    """Each batch as tensors on ``device`` (the reference places them with
    the plan's batch sharding). Only ``plan=None`` exists until the
    sharding rules are ported (ROADMAP Queue 1, item 4)."""
    if plan is not None:
        raise NotImplementedError(
            "sharded_batches: a parallel plan needs the sharding rules "
            "(ROADMAP Queue 1, item 4); pass plan=None")
    device = torch.device(device)
    for b in dataset.batches(n_steps, start_step):
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        yield out
