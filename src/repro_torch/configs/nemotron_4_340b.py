"""Nemotron-4-340B — dense decoder, GQA kv=8, squared-ReLU [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    act="relu2",
    rope="rope",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
))
