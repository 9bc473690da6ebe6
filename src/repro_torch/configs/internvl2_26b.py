"""InternVL2-26B — InternViT frontend STUB + InternLM2-20B backbone
[arXiv:2404.16821; hf].

Assignment specifies the transformer BACKBONE only (48L d=6144 48H kv=8
d_ff=16384 vocab=92553); input_specs() supplies precomputed patch embeddings
(n_vis_tokens) prepended to the text tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    n_vis_tokens=256,
    optimizer="adafactor",
)
