"""Random weights made on the device from the run's seed, in the dtype
they are served in and in the layout ``repro_torch``'s model takes; the
same tensors go to the program and to the reference.

Each leaf is one draw of a ``torch.Generator`` on the device, in bf16
(the router in f32, as the model keeps it): a matrix ~ N(0, 1 / fan-in),
the embedding ~ N(0, 0.02^2), a norm's gain 1 + N(0, 0.1^2), so that a
norm applied with the wrong gain shows in the comparison.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layout(c: dict) -> dict:
    """Leaf path -> (shape, dtype name, kind) of a dense or MoE decoder:
    ``kind`` is "matrix", "embed" or "gain"."""
    L, d, hd = c["n_layers"], c["d_model"], c["head_dim"]
    Hq, Hkv, V = c["n_heads"], c["n_kv_heads"], padded_vocab(c)
    dt = c["dtype"]
    out = {
        "embed": ((V, d), dt, "embed"),
        "blocks.ln1": ((L, d), dt, "gain"),
        "blocks.attn.w_q": ((L, d, Hq * hd), dt, "matrix"),
        "blocks.attn.w_kv": ((L, d, 2 * Hkv * hd), dt, "matrix"),
        "blocks.attn.w_o": ((L, Hq * hd, d), dt, "matrix"),
        "blocks.ln2": ((L, d), dt, "gain"),
        "final_norm": ((d,), dt, "gain"),
        "lm_head": ((d, V), dt, "matrix"),
    }
    if c.get("n_experts"):
        E, f = c["n_experts"], c["moe_d_ff"]
        out.update({
            "blocks.moe.router": ((L, d, E), "float32", "matrix"),
            "blocks.moe.w_in": ((L, E, d, f), dt, "matrix"),
            "blocks.moe.w_out": ((L, E, f, d), dt, "matrix"),
            "blocks.moe.w_gate": ((L, E, d, f), dt, "matrix"),
        })
    else:
        f = c["d_ff"]
        out.update({
            "blocks.ffn.w_in": ((L, d, f), dt, "matrix"),
            "blocks.ffn.w_out": ((L, f, d), dt, "matrix"),
            "blocks.ffn.w_gate": ((L, d, f), dt, "matrix"),
        })
    return out


def padded_vocab(c: dict) -> int:
    """Embedding and head rows, padded to a multiple of 128 as the model
    pads them; the padded ids are never sampled."""
    return -(-c["vocab_size"] // 128) * 128


def make(c: dict, seed: int, device) -> dict:
    """The nested params dict, every leaf drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    params: dict = {}
    for path, (shape, dt, kind) in layout(c).items():
        t = torch.randn(shape, generator=gen, dtype=_DTYPES[dt],
                        device=device)
        if kind == "matrix":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "embed":
            t.mul_(0.02)
        else:
            t.mul_(0.1).add_(1.0)
        node = params
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return params


def flat(tree: dict, prefix: str = "") -> dict:
    """A nested dict of tensors as {dotted path: tensor}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "."))
        else:
            out[key] = v
    return out
