"""Llama-4 Maverick 400B-A17B — MoE 128e top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Assignment config taken verbatim: 48L, d_model=5120, 40H (GQA kv=8),
d_ff=8192 per expert, vocab=202048, 128 experts top-1. Every layer is MoE
(the assignment does not specify interleaving), plus 1 shared expert as in
the Llama-4 design. Optimizer: adafactor (factored 2nd moments — required to
fit optimizer state for a 0.77T-param total config; see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    optimizer="adafactor",
)
