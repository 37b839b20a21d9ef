"""Counter-based random bits for the sampler: the reference's key stream
(``jax.random``'s default threefry2x32, ``jax_threefry_partitionable``
on) reproduced bit for bit with integer ops.

A key is a pair of uint32 words. The lanes here are int64 holding
uint32 values, masked after every add and shift, so one implementation
serves numpy arrays (keys derived on the host) and torch tensors (bits
drawn on the device) alike:

* ``key(seed)`` is ``(0, seed & 0xFFFFFFFF)`` for an int32 seed;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* the bits of shape ``(n,)`` are ``hi ^ lo`` of ``threefry2x32(k, (0, i))``
  for ``i`` in ``0..n-1``;
* ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts
  1, scales to ``[minval, maxval)`` in float32 and clamps at ``minval``;
* ``categorical`` is ``argmax(gumbel + logits)`` with the "low" Gumbel
  ``-log(-log(uniform(tiny, 1)))``, first index on ties.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 lanes (numpy or
    torch) holding uint32 values. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed):
    """Host keys ``(k0, k1)`` for int32 seeds (numpy int64 arrays)."""
    seed = np.asarray(seed, np.int64)
    return np.zeros_like(seed), seed & MASK


def fold_in(k, data):
    """``fold_in`` of uint32 ``data`` into keys ``k`` (numpy)."""
    data = np.asarray(data, np.int64) & MASK
    return threefry2x32(k[0], k[1], 0, data)


def bits(k0, k1, n: int):
    """uint32 bits (int64 lanes) of shape ``(B, n)`` for ``B`` keys given
    as (B,) int64 tensors on the device that draws them."""
    i = torch.arange(n, dtype=torch.int64, device=k0.device)[None]
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], 0, i)
    return y0 ^ y1


def uniform(b, minval: float = 0.0, maxval: float = 1.0):
    """float32 uniforms in ``[minval, maxval)`` from uint32 bits ``b``."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * scale + minval, minval)


def gumbel(b):
    """The "low" Gumbel draw from uint32 bits ``b``."""
    return -torch.log(-torch.log(uniform(b, TINY, 1.0)))


def categorical(k0, k1, logits):
    """One draw per row of ``logits`` (B, V) under keys (B,): argmax of
    logits plus Gumbel noise, first index on ties."""
    return torch.argmax(gumbel(bits(k0, k1, logits.shape[-1])) + logits,
                        dim=-1)
