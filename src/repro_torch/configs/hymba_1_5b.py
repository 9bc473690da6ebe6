"""Hymba 1.5B — hybrid: parallel attention + Mamba heads per layer
[arXiv:2411.13676; hf].

25 attention heads (GQA kv=5, head_dim=64) in parallel with a selective-SSM
(state=16) path; outputs are mean-fused after per-path norm, as in the paper.
Sliding-window attention (Hymba uses SWA in all but 3 layers) + full-history
SSM state makes the arch sub-quadratic -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    attn_window=1024,
    subquadratic=True,
    optimizer="adamw",
)
