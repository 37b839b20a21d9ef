"""DeepSeek-LLM 7B — llama-arch dense decoder [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,          # GQA kv=32 == MHA
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    act="swiglu",
    rope="rope",
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
))
