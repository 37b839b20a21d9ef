"""Qwen3-4B — dense decoder with qk_norm + GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    act="swiglu",
    qk_norm=True,
    rope="rope",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
))
