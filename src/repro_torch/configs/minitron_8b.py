"""Minitron-8B — pruned Nemotron-4 dense decoder [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    act="relu2",            # squared-ReLU (nemotron family)
    rope="rope",
    rope_theta=10_000.0,
    source="arXiv:2407.14679",
))
