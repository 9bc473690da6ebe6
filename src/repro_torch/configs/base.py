"""Model/run configuration system — a field-for-field copy of
`repro.configs.base` (the port imports nothing of the JAX package, so it
keeps its own copy; tests/test_torch_configs.py holds the two equal).

One frozen dataclass covers all 10 assigned architecture families (dense /
moe / ssm / hybrid / encdec / vlm). Every src/repro_torch/configs/<arch>.py
exports `CONFIG` built from this; `get_config` resolves `--arch <id>`
strings.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False                  # qwen-family
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"                     # swiglu | gelu
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: Optional[int] = None          # expert width (deepseek fine-grained)
    first_k_dense: int = 0                  # leading dense layers (deepseek=1)
    router_aux_coef: float = 0.01           # load-balance loss

    # --- SSM / RWKV / hybrid ---
    ssm_state: int = 0                      # mamba state size (hymba)
    rwkv_head_dim: int = 64                 # rwkv6 head size
    attn_window: int = 0                    # sliding-window attn (hymba); 0=full

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500                     # stub frontend frames
    enc_d_model: Optional[int] = None

    # --- VLM ---
    n_vis_tokens: int = 0                   # stub patch embeddings prepended

    # --- training-time knobs (defaults; launch flags override) ---
    use_flash_attention: bool = False       # Pallas flash kernel (§Perf)
    ssm_impl: str = "chunked"               # chunked | scan (hymba §Perf)
    remat: str = "full"                     # none | dots | full
    optimizer: str = "adamw"                # adamw | adafactor
    # long_500k applicability: quadratic full-attention archs must skip
    subquadratic: bool = False

    def __post_init__(self):
        assert self.family in FAMILIES, self.family
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "moe":
            assert self.n_experts > 0 and self.experts_per_token > 0
        if self.family == "ssm":
            object.__setattr__(self, "subquadratic", True)
        if self.family == "hybrid":
            object.__setattr__(self, "subquadratic", True)

    # ---- parameter counting (for the 6ND model-FLOPs convention) ----------

    def param_count(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        n = 0
        n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # lm head
        dec_layers = self.n_layers

        def attn_params():
            p = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qkv_bias:
                p += (h + 2 * kv) * hd
            return p

        def dense_ffn(ff):
            if self.act == "swiglu":
                return 3 * d * ff
            return 2 * d * ff

        if self.family in ("dense", "vlm"):
            n += dec_layers * (attn_params() + dense_ffn(self.d_ff) + 2 * d)
        elif self.family == "moe":
            ff = self.moe_d_ff or self.d_ff
            moe_layers = dec_layers - self.first_k_dense
            n += dec_layers * (attn_params() + 2 * d)
            n += self.first_k_dense * dense_ffn(self.d_ff)
            per_moe = self.n_experts * dense_ffn(ff) + self.n_shared_experts * dense_ffn(ff)
            per_moe += d * self.n_experts               # router
            n += moe_layers * per_moe
        elif self.family == "ssm":                      # rwkv6
            heads = d // self.rwkv_head_dim
            tm = 4 * d * d + d * heads * 0              # r,k,v,g? see rwkv6.py
            n += dec_layers * (5 * d * d + dense_ffn_rwkv(d, self.d_ff) + 4 * d)
        elif self.family == "hybrid":                   # hymba
            ssm_inner = d  # mamba path inner width
            mamba = 2 * d * ssm_inner + ssm_inner * (2 * self.ssm_state + 1) + ssm_inner * d
            n += dec_layers * (attn_params() + mamba + dense_ffn(self.d_ff) + 2 * d)
        elif self.family == "encdec":
            enc_d = self.enc_d_model or d
            n += self.n_enc_layers * (attn_params() + dense_ffn(self.d_ff) + 2 * d)
            # decoder self-attn + cross-attn + ffn
            n += dec_layers * (2 * attn_params() + dense_ffn(self.d_ff) + 3 * d)
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        full = self.param_count()
        moe_layers = self.n_layers - self.first_k_dense
        inactive = moe_layers * (self.n_experts - self.experts_per_token) * (3 * d * ff)
        return int(full - inactive)

    def model_flops_per_token(self, training: bool) -> float:
        """6*N_active per token trained; 2*N_active per token decoded."""
        n = self.active_param_count()
        return (6.0 if training else 2.0) * n


def dense_ffn_rwkv(d, ff):
    # rwkv channel-mix: key d->ff, value ff->d, receptance d->d
    return d * ff + ff * d + d * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned set: train_4k / prefill_32k /
    decode_32k / long_500k)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str   # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "rwkv6_7b",
    "llama4_maverick_400b_a17b",
    "deepseek_moe_16b",
    "phi4_mini_3_8b",
    "qwen2_1_5b",
    "codeqwen1_5_7b",
    "qwen2_5_32b",
    "whisper_small",
    "internvl2_26b",
    "hymba_1_5b",
)

# CLI aliases (--arch accepts either form)
ALIASES = {
    "rwkv6-7b": "rwkv6_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "whisper-small": "whisper_small",
    "internvl2-26b": "internvl2_26b",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(arch: str) -> ModelConfig:
    """The `ModelConfig` of one assigned architecture, by its id or its
    CLI alias ("qwen2-1.5b" and "qwen2_1_5b" name the same config).

    Example::

        import repro_torch
        cfg = repro_torch.get_config("qwen2-1.5b")
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads  # 28 1536 12 2
    """
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    assert arch in ARCH_IDS, f"unknown arch {arch}; known: {ARCH_IDS}"
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Which of the 4 assigned shapes a given arch runs (skips documented in
    DESIGN.md §Arch-applicability: long_500k needs sub-quadratic attention)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return tuple(names)


def reduce_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 128,
                  vocab: int = 512) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving family & structure
    (ratios like GQA grouping, expert counts scaled down)."""
    head_dim = 32
    n_heads = max(2, d_model // head_dim)
    # keep the kv:q ratio if possible
    ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_kv = max(1, n_heads // ratio)
    while n_heads % n_kv:
        n_kv -= 1
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=d_model * 3,
        vocab_size=vocab,
        head_dim=head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        act=cfg.act,
        tie_embeddings=cfg.tie_embeddings,
        remat="none",
        optimizer=cfg.optimizer,
        subquadratic=cfg.subquadratic,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, experts_per_token=min(2, cfg.experts_per_token),
                  n_shared_experts=cfg.n_shared_experts, moe_d_ff=d_model * 2,
                  first_k_dense=min(1, cfg.first_k_dense))
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=32, n_heads=d_model // 32,
                  n_kv_heads=d_model // 32)
    if cfg.family == "hybrid":
        kw.update(ssm_state=cfg.ssm_state, attn_window=64)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=layers, enc_seq=64)
    if cfg.family == "vlm":
        kw.update(n_vis_tokens=8)
    return ModelConfig(**kw)
