"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,             # wkv heads (head size 64)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    act="relu2",            # rwkv channel-mix uses squared relu
    rope="none",
    attention_free=True,
    ssm_state=64,           # per-head (hd x hd) wkv state
    source="arXiv:2404.05892",
))
