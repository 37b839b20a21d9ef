"""Bring the JAX reference's params into the port.

``params_from_numpy`` takes the tree the reference's ``init_params``
builds, converted leaf-wise to numpy (bfloat16 leaves as ``ml_dtypes``
arrays are fine), and returns the port's params tree: ``embed``,
``lm_head``, ``final_norm`` and ``blocks/...`` with a leading L axis —
``{ln1, ln2, attn/{w_q, w_kv, w_o, q_norm, k_norm}, ffn/{w_in, w_gate,
w_out}}`` for dense, ``moe/{router (f32), w_in, w_gate, w_out}`` with
the expert axis after L in place of ``ffn`` for MoE, plus ``ssm/...``
and ``ln_attn_out`` / ``ln_ssm_out`` for hybrid, ``{ln1, ln2, tmix/...,
cmix/...}`` for rwkv.
Leaves keep their names and shapes: ``w_kv`` stays one ``(d,
2*Hkv*hd)`` matrix that ``attention.qkv`` splits into k / v exactly as
the reference does.

The CV parser's models come across the same way:
``encoder_params_from_numpy`` (the sentence encoder),
``classifier_params_from_numpy`` (the section classifier) and
``lan_params_from_numpy`` (a Bi-LSTM-LAN NER model, whose
``lan_layers`` is a list).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.models import bert_encoder, bilstm_lan
from repro_torch.models.model import init_params

# a dtype no leaf holds on its own: leaves that come out of init_params
# in it follow cfg.dtype, the others keep a dtype of their own (f32)
_PROBE = torch.float16


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _join(prefix, key):
    return f"{prefix}/{key}" if prefix else str(key)


def _flatten(tree, prefix=""):
    """{"a/b/0/c": leaf} of a tree of dicts and lists."""
    out = {}
    for k, v in _items(tree):
        path = _join(prefix, k)
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _rebuild(like, fn, prefix=""):
    """``like``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, _join(prefix, k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, fn, _join(prefix, i)) for i, v in enumerate(like)]
    return fn(prefix, like)


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
    ``decay_base``, ``bonus_u``, ``A_log``, ``D``, ``dt_bias``, the MoE
``router``). Every
    leaf maps to exactly one port tensor of the same shape; a missing,
    extra or misshapen leaf raises ``ValueError``."""
    dtype = dtype or cfg.dtype
    return _convert(tree, init_params(replace(cfg, dtype=_PROBE),
                                      device="meta"), device,
                    lambda ref: dtype if ref == _PROBE else ref)


def _convert(tree, like, device, leaf_dtype=lambda ref: ref):
    """``tree``'s leaves as tensors on ``device``, in the structure of the
    port's meta-device tree ``like``; each leaf in ``leaf_dtype`` of the
    matching meta leaf's dtype. A missing, extra or misshapen leaf raises
    ``ValueError``."""
    want = _flatten(like)
    got = _flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing {missing}, "
                         f"unmapped {extra}")

    def leaf(path, ref):
        t = _to_tensor(got[path])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        return t.to(device=device, dtype=leaf_dtype(ref.dtype))

    return _rebuild(like, leaf)


def encoder_params_from_numpy(tree, cfg, device):
    """The sentence encoder's params (``bert_encoder.init_encoder``'s
    tree) from the reference's numpy tree, on ``device``."""
    return _convert(tree, bert_encoder.init_encoder(None, cfg, "meta"),
                    device)


def classifier_params_from_numpy(tree, device):
    """The section classifier's params from the reference's numpy tree."""
    return _convert(tree, bert_encoder.init_classifier(None, "meta"), device)


def lan_params_from_numpy(tree, cfg, device):
    """A Bi-LSTM-LAN model's params (``bilstm_lan.init_params``'s tree,
    ``lan_layers`` a list) from the reference's numpy tree."""
    return _convert(tree, bilstm_lan.init_params(None, cfg, "meta"), device)
