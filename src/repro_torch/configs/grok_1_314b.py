"""Grok-1 314B — MoE 8 experts top-2, GQA kv=8 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    act="geglu",
    rope="rope",
    rope_theta=10_000.0,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    source="hf:xai-org/grok-1",
))
