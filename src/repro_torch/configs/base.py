"""Architecture config schema + registry (PyTorch port of
``repro.configs.base``).

Every assigned architecture gets one module in this package defining a
full-size ``CONFIG`` (cited to its source paper / model card) plus the
family-preserving ``reduced()`` variant used by CPU smoke tests
(<=2 layers, d_model<=512, <=4 experts). Dtypes are ``torch`` dtypes.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Any

import torch

ARCH_IDS = [
    "deepseek-7b",
    "qwen3-4b",
    "minitron-8b",
    "nemotron-4-340b",
    "rwkv6-1.6b",
    "grok-1-314b",
    "qwen2-vl-2b",
    "whisper-tiny",
    "kimi-k2-1t-a32b",
    "hymba-1.5b",
]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: str = "swiglu"          # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope: str = "rope"           # rope | mrope | learned | none
    rope_theta: float = 1_000_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM / hybrid ---
    ssm_state: int = 0
    d_inner: int = 0             # 0 -> 2 * d_model
    # --- enc-dec / modality frontend (STUB: embeddings supplied) ---
    encoder_layers: int = 0
    n_frames: int = 0            # audio stub frame count
    n_patches: int = 0           # vision stub patch count (per image)
    frontend: str = "none"       # none | audio | vision
    cross_attention: bool = False
    # --- attention variant ---
    sliding_window: int = 0      # 0 = full causal attention
    attention_free: bool = False
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    source: str = ""             # citation

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dinner(self) -> int:
        return self.d_inner or (2 * self.d_model)

    @property
    def uses_attention(self) -> bool:
        return not self.attention_free

    @property
    def is_subquadratic(self) -> bool:
        """Can serve very long context without a windowed-attention override."""
        return self.attention_free or self.family in ("ssm",)

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        nmat = 3 if self.act in ("swiglu", "geglu") else 2
        if self.n_experts:
            ffn = self.n_experts * nmat * d * self.moe_d_ff + d * self.n_experts
        else:
            ffn = nmat * d * self.d_ff
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di = self.dinner
            ssm = d * di * 2 + di * d + 2 * di * max(self.ssm_state, 1)
        per_layer = (attn if self.uses_attention else 0) + ffn + ssm + 2 * d
        enc = self.encoder_layers * (attn + nmat * d * self.d_ff + 2 * d)
        return emb + self.n_layers * per_layer + enc

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        nmat = 3 if self.act == "swiglu" else 2
        dense_ffn = self.top_k * nmat * d * self.moe_d_ff
        full_ffn = self.n_experts * nmat * d * self.moe_d_ff
        return self.n_params() - self.n_layers * (full_ffn - dense_ffn)

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke-test variant (CPU, 1 device)."""
        d = min(self.d_model, 256)
        hd = 32
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(n_heads, self.n_kv_heads if self.n_kv_heads else n_heads))
        if self.n_heads == self.n_kv_heads:
            n_kv = n_heads  # preserve MHA-ness (deepseek)
        return replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            d_inner=2 * d if self.family in ("ssm", "hybrid") else 0,
            encoder_layers=min(self.encoder_layers, 2),
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype=torch.float32,
            remat=False,
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    for name in ARCH_IDS:
        get_config(name)
    return dict(_REGISTRY)
