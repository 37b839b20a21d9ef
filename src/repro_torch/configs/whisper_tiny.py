"""Whisper-tiny — enc-dec audio; mel+conv frontend STUB [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub per the assignment:
``input_specs()`` supplies pre-computed frame embeddings (B, 1500, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,        # NOT divisible by 16 -> vocab replicated (see rules)
    act="gelu",
    rope="learned",          # whisper uses learned positional embeddings
    cross_attention=True,
    frontend="audio",
    n_frames=1500,
    source="arXiv:2212.04356",
))
