"""Qwen2-VL-2B — VLM decoder with M-RoPE; vision frontend STUB [arXiv:2409.12191].

The ViT encoder + merger is a stub per the assignment: ``input_specs()``
supplies pre-computed patch embeddings of shape (B, n_patches, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    act="swiglu",
    rope="mrope",           # 3-section rotary (temporal / height / width)
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=256,          # stub: one 16x16-patch-grid image per sequence
    source="arXiv:2409.12191",
))
