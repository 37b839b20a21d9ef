"""Hymba-1.5B — hybrid: parallel attention + mamba heads per block [arXiv:2411.13676]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,       # NOT divisible by 16 -> vocab replicated (see rules)
    act="swiglu",
    rope="rope",
    rope_theta=10_000.0,
    ssm_state=16,
    d_inner=3200,
    sliding_window=2048,    # hymba local attention
    source="arXiv:2411.13676",
))
