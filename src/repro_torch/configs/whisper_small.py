"""Whisper-small — enc-dec, conv frontend STUBBED [arXiv:2212.04356; unverified].

input_specs() supplies precomputed frame embeddings (enc_seq=1500, d=768) in
place of the log-mel conv frontend (DESIGN.md §Arch-applicability). decode
shapes exercise the decoder + cross-attention; the 32k cache length is a
shape-stress configuration beyond real Whisper's 448-token decoder cap.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,             # decoder layers
    n_enc_layers=12,
    enc_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    act="gelu",
    rope_theta=0.0,          # whisper uses learned/sinusoidal pos, not RoPE
    optimizer="adamw",
)
