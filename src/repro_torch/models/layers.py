"""Shared model building blocks — the port of `repro.models.layers`
(numerics, rotary embedding, embedding/head, the cross-entropy, parameter
init).

Conventions, as in the JAX package:
  * params are nested dicts of tensors whose keys are the JAX tree's
    paths; layer stacks keep their leading "layers" axis and the model
    loops over it in Python (the JAX `lax.scan`);
  * matmuls take bf16 operands with an f32 accumulator and cast the result
    back to bf16; norms, rope and softmax run in f32.

`matmul` on a card is `torch.matmul` in bf16 (cuBLAS accumulates in f32;
the caller disables reduced-precision bf16 reductions, as chip_smoke.py
does); on the CPU it multiplies in f32 and casts once, so the CPU tests
see exactly one rounding as XLA's dot_general with
preferred_element_type=f32 does. No mesh exists in this slice, so the
row-parallel `matmul_rp` is plain `matmul`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

PARAM_DTYPE = torch.bfloat16
NORM_DTYPE = torch.float32


class ParamInit:
    """Creates parameters in the JAX ParamBuilder's order, from one
    explicit `torch.Generator`: "normal" is N(0, 1) x scale drawn in f32
    and cast; "ones"/"zeros", "const:<v>" and "a_log" (log(1..N) along
    the last axis, the mamba A init) are constants that draw nothing. The
    values differ from jax.random's; tests carry the JAX weights across
    with models.convert.params_from_numpy instead.

        init = ParamInit(seed=0, device="cuda")
        w = init.param("layers/attn/wq", (L, D, H * Hd))
    `init.shapes` afterwards maps path -> shape.
    """

    def __init__(self, seed: int, device, scale: float = 0.02):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.scale = scale
        self.shapes: Dict[str, Tuple[int, ...]] = {}

    def param(self, path: str, shape: Tuple[int, ...], init: str = "normal",
              dtype=PARAM_DTYPE) -> torch.Tensor:
        self.shapes[path] = tuple(shape)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "normal":
            w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                            device=self.device)
            return (w * self.scale).to(dtype)
        if init == "a_log":  # mamba: A = -arange(1..N) broadcast over channels
            row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                         device=self.device))
            return row.to(dtype).expand(shape).contiguous()
        if init.startswith("const:"):
            return torch.full(shape, float(init.split(":")[1]), dtype=dtype,
                              device=self.device)
        raise ValueError(init)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32 accumulate -> bf16, contracting x's last axis
    with w's first."""
    if x.is_cuda:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(PARAM_DTYPE)


matmul_rp = matmul


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(NORM_DTYPE)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(NORM_DTYPE)).to(x.dtype)


def swiglu(x, wi, wg, wo):
    """SwiGLU FFN: silu(x@wg) * (x@wi) @ wo."""
    h = matmul(x, wi)
    g = matmul(x, wg)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return matmul_rp(h, wo)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, Hd); positions: (S,) or broadcastable (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (Hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, Hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, table_or_head: torch.Tensor) -> torch.Tensor:
    """Project to the vocabulary in f32: bf16 operands, whose products are
    exact in f32, multiplied and summed in f32."""
    return torch.matmul(x.float(), table_or_head.float())


def softmax_xent(logits_f32: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Cross-entropy with the PaLM-style z-loss: lse - ll + z_loss * lse^2
    per token. logits: (..., V) f32; labels: (...) int (each in [0, V))."""
    lse = torch.logsumexp(logits_f32, dim=-1)
    ll = torch.gather(logits_f32, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss
