"""The decoder's blocks — the port of the dense and hybrid parts of
`repro.models.transformer`: parameter construction (`_attn_params`,
`_ffn_params`, `_mamba_params`, the dense and hybrid branches of
`build_param_fn`, :45-76, :130-147, :150-188, :217-222), `_qkv` (:231),
`attn_block` (:245), `attn_block_decode` (:276, the scalar-pos, per-row
and ring-buffer branches) and `mamba_path` (:450-510, every `ssm_impl`).

The other families' blocks (moe, rwkv, whisper, vlm), the sharded-decode
branch of `attn_block_decode`, `attn_block_decode_k` and
`attn_block_continue` wait for their slices.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models.layers import (PARAM_DTYPE, ParamInit, apply_rope,
                                       matmul, matmul_rp)

# the families whose params, prefill and decode the port builds
PORTED_FAMILIES = ("dense", "hybrid")


# ===========================================================================
# parameter construction
# ===========================================================================

def _attn_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": b.param(f"{pre}/wq", (L, d, h * hd)),
        "wk": b.param(f"{pre}/wk", (L, d, kv * hd)),
        "wv": b.param(f"{pre}/wv", (L, d, kv * hd)),
        "wo": b.param(f"{pre}/wo", (L, h * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = b.param(f"{pre}/bq", (L, h * hd), "zeros")
        p["bk"] = b.param(f"{pre}/bk", (L, kv * hd), "zeros")
        p["bv"] = b.param(f"{pre}/bv", (L, kv * hd), "zeros")
    return p


def _ffn_params(b: ParamInit, pre: str, L: int, d: int, f: int, act: str
                ) -> Dict:
    if act != "swiglu":
        raise NotImplementedError(f"act {act!r}: the gelu FFN comes with the "
                                  "encdec family (ROADMAP queue 1, item 8)")
    return {
        "wi": b.param(f"{pre}/wi", (L, d, f)),
        "wg": b.param(f"{pre}/wg", (L, d, f)),
        "wo": b.param(f"{pre}/wo", (L, f, d)),
    }


def _mamba_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    ci = 2 * d                      # d_inner
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)
    return {
        "in_proj": b.param(f"{pre}/in_proj", (L, d, 2 * ci)),
        "conv_w": b.param(f"{pre}/conv_w", (L, mamba_lib.CONV_K, ci)),
        "x_proj": b.param(f"{pre}/x_proj", (L, ci, dt_rank + 2 * n)),
        "dt_proj": b.param(f"{pre}/dt_proj", (L, dt_rank, ci)),
        # dt ~= softplus(-4.6) ~= 0.01 at init (the usual mamba dt range)
        "dt_bias": b.param(f"{pre}/dt_bias", (L, ci), "const:-4.6"),
        "a_log": b.param(f"{pre}/a_log", (L, ci, n), "a_log"),
        "d": b.param(f"{pre}/d", (L, ci), "ones"),
        "out_proj": b.param(f"{pre}/out_proj", (L, ci, d)),
        "norm_attn": b.param(f"{pre}/norm_attn", (L, d), "ones"),
        "norm_ssm": b.param(f"{pre}/norm_ssm", (L, d), "ones"),
    }


def build_param_fn(cfg: ModelConfig) -> Callable[[ParamInit], Dict]:
    """A function of a ParamInit that makes the param tree of a dense or
    hybrid cfg, with the JAX tree's keys, shapes and draw order."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port builds "
            f"{PORTED_FAMILIES} (ROADMAP queue 1, item 8 lists the others)")
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers

    def fn(b: ParamInit) -> Dict:
        p: Dict = {"embed": b.param("embed", (v, d))}
        p["layers"] = {
            "ln1": b.param("layers/ln1", (L, d), "ones"),
            "ln2": b.param("layers/ln2", (L, d), "ones"),
            "attn": _attn_params(b, "layers/attn", L, cfg),
        }
        if cfg.family == "hybrid":
            p["layers"]["mamba"] = _mamba_params(b, "layers/mamba", L, cfg)
        p["layers"]["ffn"] = _ffn_params(b, "layers/ffn", L, d, cfg.d_ff,
                                         cfg.act)
        p["final_norm"] = b.param("final_norm", (d,), "ones")
        if not cfg.tie_embeddings:
            p["head"] = b.param("head", (d, v))
        return p

    return fn


# ===========================================================================
# blocks (apply)
# ===========================================================================

def _qkv(lp, x, cfg: ModelConfig):
    b_, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = matmul(x, lp["wq"])
    k = matmul(x, lp["wk"])
    v = matmul(x, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    return (q.reshape(b_, s, h, hd), k.reshape(b_, s, kv, hd),
            v.reshape(b_, s, kv, hd))


def attn_block(lp, x, cfg: ModelConfig, *, positions, window=0,
               kv_valid=None):
    """Full-sequence attention (prefill). Returns (out, (k, v)).

    positions: (S,) shared, or (B,S) per-row (left-padded prefill).
    kv_valid: optional (B,S) bool marking real (non-pad) key/value
    columns."""
    b_, s, _ = x.shape
    q, k, v = _qkv(lp, x, cfg)
    if cfg.rope_theta:
        # (B,S) positions broadcast over the head axis of the (B,H,S,Hd)
        # rope input as (B,1,S)
        pos_r = positions if positions.dim() == 1 else positions[:, None]
        q = apply_rope(q.transpose(1, 2), pos_r, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos_r, cfg.rope_theta).transpose(1, 2)
    if (cfg.use_flash_attention and window == 0 and s % 256 == 0
            and kv_valid is None):
        # the flash kernel (csrc/flash.cu): no (S,S) score tensor ever
        # reaches device memory; the same three conditions as the JAX
        # package (transformer.py:260-261)
        out = attn_lib.flash_attention(q, k, v, causal=True)
    else:
        out = attn_lib.chunked_causal_attention(q, k, v, window=window,
                                                kv_valid=kv_valid)
    out = matmul_rp(out.reshape(b_, s, -1), lp["wo"])
    return out, (k, v)


def attn_block_decode(lp, x, cfg: ModelConfig, *, cache_k, cache_v, pos,
                      window=0, ring=False):
    """One-token attention against a cache. cache_k/v: (B,L,KvH,Hd),
    updated IN PLACE (the JAX version returns new arrays).

    pos is the write position — a 0-d tensor shared by all rows (lockstep
    decode) or a (B,) tensor when every row is at its own offset (the
    slot scheduler). The JAX per-row one-hot select becomes an indexed
    in-place write of each row's line (index_put_), and the shared-pos
    dynamic_update_slice an index_copy_; both stay on the device. pos must
    lie inside the cache (the engine's admission guarantees it), unless
    ring: then the cache is a ring buffer of the last L positions (the
    hybrid family's sliding window), the line is pos % L, and every line
    below min(pos + 1, L) is valid (the window is the buffer's size)."""
    b_, s, _ = x.shape
    assert s == 1
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.dim() == 1
    q, k, v = _qkv(lp, x, cfg)
    if cfg.rope_theta:
        # scalar pos -> one shared position; vector pos -> (B,1,1) so the
        # angle table broadcasts over heads per row
        pvec = pos[:, None, None] if per_row else pos.reshape(1)
        q = apply_rope(q.transpose(1, 2), pvec, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pvec, cfg.rope_theta).transpose(1, 2)
    lcache = cache_k.shape[1]
    line = pos.long() % lcache if ring else pos.long()
    if per_row:
        rows = torch.arange(b_, device=x.device)
        cache_k.index_put_((rows, line), k[:, 0])
        cache_v.index_put_((rows, line), v[:, 0])
    else:
        cache_k.index_copy_(1, line.reshape(1), k)
        cache_v.index_copy_(1, line.reshape(1), v)
    if ring:
        out = attn_lib.decode_attention(q, cache_k, cache_v,
                                        torch.clamp_max(pos + 1, lcache))
    else:
        out = attn_lib.decode_attention(q, cache_k, cache_v, pos + 1,
                                        window=window)
    out = matmul_rp(out.reshape(b_, 1, -1), lp["wo"])
    return out, (cache_k, cache_v)


def mamba_path(mp, x, cfg: ModelConfig, *, conv_state=None, h_state=None,
               decode: bool = False):
    """Mamba selective-SSM path of the Hymba block. x: (B,T,D) bf16.
    Returns (y (B,T,D) bf16, new conv state (B,K-1,Ci) bf16, new h state
    (B,Ci,N) f32).

    The scan by cfg.ssm_impl, as the JAX package: "pallas" dispatches the
    registry's "ssm" kernel (csrc/ssm_scan.cu on the card) with an SsmKey
    of this (B, T, Ci, N) and a model-only blk_c, as flash's
    `_dispatch_flash` (no timing pass on the model path); "chunked" runs
    ssm_chunked at chunk 64 when T % 64 == 0 and the sequential scan
    otherwise; "scan" the sequential scan; "stub" (prefill only) skips the
    scan and keeps the projections. Decode runs ssm_decode whatever the
    setting."""
    b_, t, d = x.shape
    ci = 2 * d
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)

    xz = matmul(x, mp["in_proj"])                          # (B,T,2Ci)
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, conv_state = mamba_lib.causal_conv1d(xs, mp["conv_w"], conv_state)
    xs = torch.nn.functional.silu(xs.float()).to(PARAM_DTYPE)

    proj = matmul(xs, mp["x_proj"]).float()                # (B,T,dtr+2N)
    dt_in, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = torch.nn.functional.softplus(dt_in @ mp["dt_proj"].float()
                                      + mp["dt_bias"].float())

    if h_state is None:
        h_state = torch.zeros((b_, ci, n), dtype=torch.float32,
                              device=x.device)
    if cfg.ssm_impl == "stub" and not decode:
        y = xs.float() * mp["d"].float()
        y = y * torch.nn.functional.silu(z.float())
        return (matmul(y.to(PARAM_DTYPE), mp["out_proj"]), conv_state,
                h_state)
    if decode:
        y, h_state = mamba_lib.ssm_decode(
            xs[:, 0].float(), dt[:, 0], bmat[:, 0], cmat[:, 0], mp["a_log"],
            mp["d"], h_state)
        y = y[:, None]
    elif cfg.ssm_impl == "pallas":
        y, h_state = _dispatch_ssm(xs.float(), dt, bmat.contiguous(),
                                   cmat.contiguous(), mp["a_log"], mp["d"],
                                   h_state)
    else:
        chunk = 64 if (t % 64 == 0 and cfg.ssm_impl == "chunked") else 1
        if chunk > 1:
            y, h_state = mamba_lib.ssm_chunked(
                xs.float(), dt, bmat, cmat, mp["a_log"], mp["d"], h_state,
                chunk=chunk)
        else:
            y, h_state = mamba_lib.ssm_scan(
                xs.float(), dt, bmat, cmat, mp["a_log"], mp["d"], h_state)

    y = y * torch.nn.functional.silu(z.float())
    out = matmul(y.to(PARAM_DTYPE), mp["out_proj"])
    return out, conv_state, h_state


def _dispatch_ssm(x, dt, bmat, cmat, a_log, d, h0):
    """The registry's "ssm" kernel under a model-only tuned blk_c, keyed on
    SsmKey(B, T, Ci, N) (one device: the whole channel axis); a shape the
    tune menu cannot tile resolves to the clamped static config."""
    from repro_torch.kernels.ssm import ops as ssm_ops
    from repro_torch.kernels.ssm.kernel_def import SsmKey
    from repro_torch.tune import tuner
    b_, t, ci = x.shape
    key = SsmKey(b=b_, t=t, c=ci, n=a_log.shape[1])
    try:
        cfg = tuner.tune_kernel("ssm", key, measure_mode=False,
                                device=x.device).config
    except ValueError:            # empty config space at this shape
        cfg = None
    return ssm_ops.ssm_scan(x, dt, bmat, cmat, a_log, d, h0, config=cfg,
                            device=x.device, problem_key=key)
