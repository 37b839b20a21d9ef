"""The plain reference of the served decoders: a dense or MoE pre-norm
decoder's logits, computed from the benchmark's weights in float32 with
TF32 off, layer by layer over whole sequences, with no cache, no batching
and no kernel.

It computes what the port's decoder computes (``repro_torch``'s
``models/{layers,attention,moe,transformer,model}.py``), written again
from the equations: RMSNorm ``x / sqrt(mean(x^2) + eps) * g``; rotary
embedding on the two halves of each head (``x1 cos - x2 sin``, ``x1 sin
+ x2 cos``) at frequencies ``theta^(-2i / hd)``; causal softmax attention
with scale ``hd^-1/2``, query head h reading key head ``h // (Hq /
Hkv)``; a gated FFN ``act(x W_gate) * (x W_in) W_out`` (silu for swiglu,
tanh-approximated gelu for geglu); for MoE layers a router ``softmax(x
W_r)`` in f32, each token's ``top_k`` experts (ties to the lower index),
their probabilities renormalised to sum to 1 and the experts' outputs
added with those weights. No token is dropped: the configurations give
every expert room for every token (``capacity_factor = n_experts /
top_k``). The final RMSNorm and the head give logits over the vocabulary.

``precision="fp8"`` is the control: every product the configuration runs
in bf16 takes its weight and its input rounded to float8 e4m3 (per-tensor
scale for a weight, per-row for an input; the attention's q, k and v per
row and head), accumulated in f32. The router stays f32, as configured.

This module imports nothing of the program and takes nothing it made.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


@contextmanager
def full_f32():
    """Float32 products in full precision (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` (f32) rounded to e4m3 with one scale per slice over
    ``dims`` (the amax over those dims maps to 448), back in f32."""
    amax = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    s = amax / _E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Prec:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.low = precision == "fp8"

    def w(self, t):
        """A bf16 weight as the products read it."""
        t = t.float()
        return fp8(t, tuple(range(t.ndim))) if self.low else t

    def x(self, t, dims=(-1,)):
        """An input of a bf16 product."""
        return fp8(t, dims) if self.low else t


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope(x, pos, theta):
    """x (S, H, hd) at positions pos (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs                     # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def act(name):
    if name == "swiglu":
        return F.silu
    if name == "geglu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"activation {name!r}")


def attention(q, k, v, q_rows: int = 512):
    """Causal attention of one sequence: q (S, Hq, hd), k / v (S, Hkv,
    hd), in blocks of ``q_rows`` queries."""
    S, Hq, hd = q.shape
    G = Hq // k.shape[1]
    kx = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (Hq, S, hd)
    vx = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, S, q_rows):
        b = min(a + q_rows, S)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], kx[:, :b]) / math.sqrt(hd)
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(j > i, float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                vx[:, :b])
    return out


def moe(h, w, c, l, pr: _Prec, margins=None):
    """Dropless top-k MoE FFN of tokens h (T, d) at layer l. ``margins``
    (T,), when given, takes the least gap so far between each token's
    k-th and (k+1)-th router logit: how near its choice of experts was to
    another."""
    r = h @ w["router"][l].float()
    if margins is not None:
        srt = torch.sort(r, dim=-1, descending=True).values
        k = c["top_k"]
        torch.minimum(margins, srt[:, k - 1] - srt[:, k], out=margins)
    probs = torch.softmax(r, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, ids = top[:, : c["top_k"]], ids[:, : c["top_k"]]
    top = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    f = act(c["act"])
    out = torch.zeros_like(h)
    hx = pr.x(h)
    for e in range(c["n_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = hx[rows]
        ye = f(xe @ pr.w(w["w_gate"][l, e])) * (xe @ pr.w(w["w_in"][l, e]))
        ye = pr.x(ye) @ pr.w(w["w_out"][l, e])
        out.index_add_(0, rows, ye * top[rows, slot][:, None])
    return out


def logits(weights: dict, c: dict, seqs: list, want: list,
           precision: str = "f32", margins: list | None = None) -> list:
    """For each sequence ``seqs[i]`` (token ids), the logits (f32, over
    the vocabulary) at the positions ``want[i]``. Layer by layer over all
    sequences, so each layer's weights are read once. A MoE model fills
    ``margins`` (a list) with each sequence's least router margin a
    position (see :func:`moe`)."""
    pr = _Prec(precision)
    dev = weights["embed"].device
    blocks = weights["blocks"]
    L, eps = c["n_layers"], c["norm_eps"]
    Hq, Hkv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    f = act(c["act"])
    with torch.no_grad(), full_f32():
        xs = [weights["embed"][torch.as_tensor(s, device=dev)].float()
              for s in seqs]
        if margins is not None and c.get("n_experts"):
            margins[:] = [torch.full((len(s),), float("inf"), device=dev)
                          for s in seqs]
        else:
            margins = None
        for l in range(L):
            a = blocks["attn"]
            wq, wkv, wo = (pr.w(a[k][l]) for k in ("w_q", "w_kv", "w_o"))
            for i, x in enumerate(xs):
                S = x.shape[0]
                pos = torch.arange(S, device=dev)
                h = pr.x(rmsnorm(x, blocks["ln1"][l], eps))
                q = (h @ wq).reshape(S, Hq, hd)
                kv = (h @ wkv).reshape(S, 2, Hkv, hd)
                q = pr.x(rope(q, pos, c["rope_theta"]))
                k = pr.x(rope(kv[:, 0], pos, c["rope_theta"]))
                v = pr.x(kv[:, 1])
                o = attention(q, k, v).reshape(S, Hq * hd)
                xs[i] = x + pr.x(o) @ wo
            del wq, wkv, wo
            if c.get("n_experts"):
                for i, x in enumerate(xs):
                    h = rmsnorm(x, blocks["ln2"][l], eps)
                    xs[i] = x + moe(h, blocks["moe"], c, l, pr,
                                    None if margins is None else margins[i])
            else:
                m = blocks["ffn"]
                wg, wi, wout = (pr.w(m[k][l])
                                for k in ("w_gate", "w_in", "w_out"))
                for i, x in enumerate(xs):
                    h = pr.x(rmsnorm(x, blocks["ln2"][l], eps))
                    xs[i] = x + pr.x(f(h @ wg) * (h @ wi)) @ wout
                del wg, wi, wout
        head = pr.w(weights["lm_head"])[:, : c["vocab_size"]]
        out = []
        for x, pos in zip(xs, want):
            h = rmsnorm(x[torch.as_tensor(pos, device=dev)],
                        weights["final_norm"], eps)
            out.append(pr.x(h) @ head)
        return out
