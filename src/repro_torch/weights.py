"""Bring the JAX reference's params into the port.

``params_from_numpy`` takes the tree the reference's ``init_params``
builds, converted leaf-wise to numpy (bfloat16 leaves as ``ml_dtypes``
arrays are fine), and returns the port's params tree: ``embed``,
``lm_head``, ``final_norm`` and ``blocks/...`` with a leading L axis —
``{ln1, ln2, attn/{w_q, w_kv, w_o, q_norm, k_norm}, ffn/{w_in, w_gate,
w_out}}`` for dense, plus ``ssm/...`` and ``ln_attn_out`` /
``ln_ssm_out`` for hybrid, ``{ln1, ln2, tmix/..., cmix/...}`` for rwkv.
Leaves keep their names and shapes: ``w_kv`` stays one ``(d,
2*Hkv*hd)`` matrix that ``attention.qkv`` splits into k / v exactly as
the reference does.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.models.model import init_params

# a dtype no leaf holds on its own: leaves that come out of init_params
# in it follow cfg.dtype, the others keep a dtype of their own (f32)
_PROBE = torch.float16


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes: no numpy bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(tree, cfg, device, dtype=None):
    """The port's params for ``cfg`` from the reference's numpy tree, on
    ``device``. Leaves that follow ``cfg.dtype`` are cast to ``dtype``
    (default ``cfg.dtype``); the others keep the dtype the port's own
    ``init_params`` gives them (f32 where the reference keeps f32:
    ``decay_base``, ``bonus_u``, ``A_log``, ``D``, ``dt_bias``). Every
    leaf maps to exactly one port tensor of the same shape; a missing,
    extra or misshapen leaf raises ``ValueError``."""
    want = _flatten(init_params(replace(cfg, dtype=_PROBE), device="meta"))
    got = _flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing {missing}, "
                         f"unmapped {extra}")
    dtype = dtype or cfg.dtype
    out: dict = {}
    for path, ref in want.items():
        t = _to_tensor(got[path])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.to(device=device,
                          dtype=dtype if ref.dtype == _PROBE else ref.dtype)
    return out
