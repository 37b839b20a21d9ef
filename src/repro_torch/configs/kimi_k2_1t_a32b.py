"""Kimi-K2 1T-A32B — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,           # d_model / n_heads
    d_ff=2048,
    vocab_size=163840,
    act="swiglu",
    rope="rope",
    rope_theta=50_000.0,
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    capacity_factor=1.5,
    source="arXiv:2501.kimi2",
))
