"""Qwen2 1.5B — GQA kv=2, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,    # qwen2 small models tie embeddings
    optimizer="adamw",
)
