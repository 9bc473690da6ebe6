"""DeepSeekMoE 16B — fine-grained experts: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

Assignment d_ff=1408 is the fine-grained expert width (moe_d_ff). The first
layer is dense (first_k_dense=1) with the paper's dense FFN width 10944.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # assignment: GQA kv=16 (= MHA)
    d_ff=10944,             # dense-layer FFN width (paper)
    vocab_size=102400,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,          # assignment's d_ff: fine-grained expert width
    first_k_dense=1,
    optimizer="adamw",
)
