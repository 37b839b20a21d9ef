"""The benchmark's frozen yardstick: the H100's data-sheet peaks, the work
of the attention kernels, and the model FLOPs a served token needs.

The peaks are those of ``repro_torch/launch/mesh.py`` and the kernel
costs those of ``repro_torch/kernels/costs.py`` (flash forward, paged
window), copied here so that a change to the program cannot move the
yardstick it is measured by. Nothing here imports the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, per card, at its 700 W limit.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores
HBM_BW = 3.35e12              # B/s, HBM3


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: compute or memory bound."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BW)


# ------------------------------------------------------------ kernel work
def flash(B, Hq, Hkv, S, T, hd, itemsize=2):
    """The causal flash forward without a window: q, k, v read once, out
    written once; 4 * hd flops per (query head, key) pair, S * T / 2
    pairs. Returns (flops, bytes)."""
    nbytes = itemsize * B * hd * (2 * S * Hq + 2 * T * Hkv)
    return 4 * B * Hq * hd * (S * T / 2), nbytes


def paged_window(bases, S, Hq, Hkv, hd, bs, max_blocks, itemsize=2):
    """A window of S queries a row over the paged pool (``bases``: the
    tokens each row holds before its window), no sliding window: the K/V
    of every position the row's window sees read once, q read once, out
    and lse written once, the block table and bases read once; 4 * hd
    flops per (query head, visible key). Returns (flops, bytes)."""
    cap = max_blocks * bs
    B = len(bases)
    seen = [min(b + S, cap) for b in bases]
    kv_bytes = sum(seen) * Hkv * hd * 2 * itemsize
    io_bytes = (2 * B * S * Hq * hd * itemsize + B * S * Hq * 4
                + B * (max_blocks + 1) * 4)
    pairs = sum(min(b + w + 1, cap) for b in bases for w in range(S)) * Hq
    return 4 * hd * pairs, kv_bytes + io_bytes


# ------------------------------------------------------------ model FLOPs
def layer_params(c: dict) -> int:
    """Weights of one layer that a token multiplies by: attention
    projections and the FFN (for a MoE layer, the ``top_k`` experts it is
    routed to and the router)."""
    d, hd = c["d_model"], c["head_dim"]
    attn = d * c["n_heads"] * hd + d * 2 * c["n_kv_heads"] * hd \
        + c["n_heads"] * hd * d
    if c.get("n_experts"):
        ffn = c["top_k"] * 3 * d * c["moe_d_ff"] + d * c["n_experts"]
    else:
        ffn = 3 * d * c["d_ff"]
    return attn + ffn


def token_flops(c: dict, visible: int, head: bool) -> float:
    """Model FLOPs of one token at a position that sees ``visible`` keys
    (itself included): 2 x the layer weights it uses, the attention's 4 *
    hd * heads * visible a layer, and the LM head where its logits are
    needed."""
    per_layer = 2 * layer_params(c) + 4 * c["head_dim"] * c["n_heads"] \
        * visible
    out = c["n_layers"] * per_layer
    if head:
        out += 2 * c["d_model"] * c["vocab_size"]
    return float(out)


def prefill_flops(c: dict, P: int) -> float:
    """A prompt of P tokens: position i sees i + 1 keys; the head only at
    the last position."""
    per_layer = 2 * layer_params(c) * P + 4 * c["head_dim"] * c["n_heads"] \
        * (P * (P + 1) // 2)
    return float(c["n_layers"] * per_layer + 2 * c["d_model"]
                 * c["vocab_size"])


def decode_flops(c: dict, base: int) -> float:
    """One generated token fed at a row that holds ``base`` tokens."""
    return token_flops(c, base + 1, head=True)
