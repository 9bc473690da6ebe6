"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # 4096 / rwkv_head_dim(64)
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    subquadratic=True,     # state is O(1) in sequence length -> runs long_500k
    optimizer="adamw",
)
