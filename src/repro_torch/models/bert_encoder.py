"""Sentence encoder + sectioning classifier (paper §3.2.2; port of the
reference's ``models/bert_encoder.py``).

The paper encodes each CV sentence with BERT (uncased_L-12_H-768_A-12 —
768-d [CLS] vectors) and classifies it into 4 sections with the Keras
model:

    dense_1: Dense(768 -> 200), dense_2: Dense(200 -> 4)
    Total params: 154,604  (153,800 + 804)

The classifier is reproduced exactly; a small transformer encoder
(mean-pooled) stands in for the frozen BERT. On CUDA tensors its
attention goes through the flash kernel with ``causal=False``, once per
layer per call; on CPU tensors through the plain masked softmax.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, transformer

EMBED_DIM = 768
HIDDEN = 200
N_SECTIONS = 4


def encoder_config(vocab_size: int = 8192) -> ArchConfig:
    return ArchConfig(
        name="sentence-encoder", family="dense", n_layers=4, d_model=EMBED_DIM,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=vocab_size, act="gelu", rope="learned",
        dtype=torch.float32, remat=False, source="arXiv:1810.04805 (stand-in)")


def init_encoder(gen, cfg: ArchConfig, device):
    """Embedding, a 512-row learned position table, ``cfg.n_layers``
    dense blocks stacked on a leading L axis, the final norm; drawn from
    ``gen`` (None only on the meta device)."""
    d, dtype = cfg.d_model, cfg.dtype

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(0.02).to(dtype)

    return {
        "embed": normal((cfg.vocab_size, d)),
        "pos": normal((512, d)),
        "blocks": transformer.init_block(gen, cfg, kind="dense",
                                         device=device,
                                         lead=(cfg.n_layers,)),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }


def encode_sentences(params, cfg: ArchConfig, tokens: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) int -> sentence embeddings (B, 768), mean-pooled.

    Every position attends to every other, padding included, as in the
    reference: ``mask`` (B, S) only weights the pool."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()] + params["pos"][None, :S, :]
    eps = cfg.norm_eps
    for l in range(params["blocks"]["ln1"].shape[0]):
        bp = transformer._layer(params["blocks"], l)
        hh = layers.rmsnorm(x, bp["ln1"], eps)
        o, _ = attention.attention_block(hh, bp["attn"], cfg, mode="train",
                                         causal=False)
        x = x + o
        hh = layers.rmsnorm(x, bp["ln2"], eps)
        x = x + layers.mlp(hh, bp["ffn"], cfg.act)
    x = layers.rmsnorm(x, params["final_norm"], eps)
    if mask is None:
        return torch.mean(x, dim=1)
    m = mask[..., None].to(x.dtype)
    return torch.sum(x * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0)


# ------------------------------------------------------- section classifier
def init_classifier(gen, device):
    """The paper's exact sequential model: 768->200->4 with biases, f32."""
    f32 = torch.float32
    return {
        "dense_1": {"w": layers.dense_init(gen, EMBED_DIM, HIDDEN, f32,
                                           device),
                    "b": torch.zeros((HIDDEN,), dtype=f32, device=device)},
        "dense_2": {"w": layers.dense_init(gen, HIDDEN, N_SECTIONS, f32,
                                           device),
                    "b": torch.zeros((N_SECTIONS,), dtype=f32,
                                     device=device)},
    }


def classifier_n_params(params) -> int:
    return sum(t.numel() for layer in params.values() for t in layer.values())


def classify_sections(params, embeddings: torch.Tensor) -> torch.Tensor:
    """embeddings (B, 768) -> section logits (B, 4)."""
    h = torch.tanh(embeddings @ params["dense_1"]["w"]
                   + params["dense_1"]["b"])
    return h @ params["dense_2"]["w"] + params["dense_2"]["b"]


def classifier_loss(params, embeddings, labels):
    """Mean cross-entropy of the section classifier: embeddings (B, 768),
    labels (B,) section ids."""
    return layers.softmax_xent(classify_sections(params, embeddings), labels)
