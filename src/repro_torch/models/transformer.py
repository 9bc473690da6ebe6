"""The model's blocks — the port of `repro.models.transformer` for every
family: parameter construction (`_attn_params`, `_ffn_params` with its
SwiGLU and gelu forms, `_moe_params`, `_rwkv_params`, `_mamba_params`,
and `build_param_fn` :45-227, whose dense branch also builds vlm and
whose encdec branch builds whisper's encoder and decoder stacks),
`_qkv` (:231), `attn_block` (:245), `attn_block_decode` (:276, the
scalar-pos, per-row and ring-buffer branches; rope=False skips the
rotation, as whisper's decoder asks), `attn_block_decode_k` (:321),
`attn_block_continue` (:352), `rwkv_time_mix` (:389), `rwkv_channel_mix`
(:440) and `mamba_path` (:450-510, every `ssm_impl`).

`mamba_path`'s "pallas" scan runs under `SsmScanNoGrad`: the kernel has
no backward, as the JAX package's Pallas scan has none, so a gradient
through it raises (on the CPU too, where the plain version stands in the
kernel's place and would otherwise differentiate). Training takes
"chunked" or "scan".

The sharded-decode branch of `attn_block_decode` waits for the
distribution slice (ROADMAP queue 1, item 9). The moe FFN itself is
`models/moe.py`, the WKV forms `models/rwkv6.py`; whisper's encoder and
decoder stacks are in `models/registry.py`, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.layers import (PARAM_DTYPE, ParamInit, apply_rope,
                                       matmul, matmul_rp)

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
    """SwiGLU (wi, wg, wo) or, for any other act, whisper's gelu FFN (wi,
    bi, wo, bo; the biases zero)."""
    if act == "swiglu":
        return {
            "wi": b.param(f"{pre}/wi", (L, d, f)),
            "wg": b.param(f"{pre}/wg", (L, d, f)),
            "wo": b.param(f"{pre}/wo", (L, f, d)),
        }
    return {
        "wi": b.param(f"{pre}/wi", (L, d, f)),
        "bi": b.param(f"{pre}/bi", (L, f), "zeros"),
        "wo": b.param(f"{pre}/wo", (L, f, d)),
        "bo": b.param(f"{pre}/bo", (L, d), "zeros"),
    }


def _moe_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d, e, f = cfg.d_model, cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
    p = {
        "router": b.param(f"{pre}/router", (L, d, e)),
        "wi": b.param(f"{pre}/wi", (L, e, d, f)),
        "wg": b.param(f"{pre}/wg", (L, e, d, f)),
        "wo": b.param(f"{pre}/wo", (L, e, f, d)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = b.param(f"{pre}/shared_wi", (L, d, fs))
        p["shared_wg"] = b.param(f"{pre}/shared_wg", (L, d, fs))
        p["shared_wo"] = b.param(f"{pre}/shared_wo", (L, fs, d))
    return p


def _rwkv_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    km, kd = rwkv_lib.LORA_MIX, rwkv_lib.LORA_DECAY
    f = cfg.d_ff
    return {
        "ln1": b.param(f"{pre}/ln1", (L, d), "ones"),
        "ln2": b.param(f"{pre}/ln2", (L, d), "ones"),
        "tm": {
            "mu_x": b.param(f"{pre}/tm/mu_x", (L, d)),
            # the r, k, v, w and g streams' mus
            "mu_5": b.param(f"{pre}/tm/mu_5", (L, 5, d)),
            "lora_a": b.param(f"{pre}/tm/lora_a", (L, d, 5 * km)),
            "lora_b": b.param(f"{pre}/tm/lora_b", (L, 5, km, d)),
            "td_a": b.param(f"{pre}/tm/td_a", (L, d, kd)),
            "td_b": b.param(f"{pre}/tm/td_b", (L, kd, d)),
            "w0": b.param(f"{pre}/tm/w0", (L, d)),
            "u": b.param(f"{pre}/tm/u", (L, h, hd)),
            "wr": b.param(f"{pre}/tm/wr", (L, d, d)),
            "wk": b.param(f"{pre}/tm/wk", (L, d, d)),
            "wv": b.param(f"{pre}/tm/wv", (L, d, d)),
            "wg": b.param(f"{pre}/tm/wg", (L, d, d)),
            "wo": b.param(f"{pre}/tm/wo", (L, d, d)),
            "ln_x": b.param(f"{pre}/tm/ln_x", (L, d), "ones"),
        },
        "cm": {
            "mu_k": b.param(f"{pre}/cm/mu_k", (L, d)),
            "mu_r": b.param(f"{pre}/cm/mu_r", (L, d)),
            "wk": b.param(f"{pre}/cm/wk", (L, d, f)),
            "wv": b.param(f"{pre}/cm/wv", (L, f, d)),
            "wr": b.param(f"{pre}/cm/wr", (L, d, d)),
        },
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
    """A function of a ParamInit that makes the param tree of cfg, with the
    JAX tree's keys, shapes and draw order. dense and vlm: one "layers"
    stack (vlm's patch embeddings come with the batch). moe: the first
    `first_k_dense` layers are dense ("dense_layers", FFN width d_ff), the
    rest ("layers") carry the router and the experts. ssm (rwkv6):
    "layers" holds ln1/ln2, the time mix "tm" and the channel mix "cm".
    encdec (whisper): "enc_layers" (LayerNorm scales and biases, attention,
    gelu FFN) and "dec_layers" (the same with the cross-attention "xattn"
    behind "lnx"/"lnxb"), the encoder's final "enc_ln"/"enc_lnb", the
    learned decoder positions "dec_pos" (32768, d) and the final norm's
    bias "final_normb"."""
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers

    def stack(b: ParamInit, pre: str, n: int) -> Dict:
        return {"ln1": b.param(f"{pre}/ln1", (n, d), "ones"),
                "ln2": b.param(f"{pre}/ln2", (n, d), "ones"),
                "attn": _attn_params(b, f"{pre}/attn", n, cfg)}

    def whisper_stack(b: ParamInit, pre: str, n: int, cross: bool) -> Dict:
        norms = ("ln1", "lnx", "ln2") if cross else ("ln1", "ln2")
        p = {}
        for name in norms:
            p[name] = b.param(f"{pre}/{name}", (n, d), "ones")
            p[f"{name}b"] = b.param(f"{pre}/{name}b", (n, d), "zeros")
        p["attn"] = _attn_params(b, f"{pre}/attn", n, cfg)
        if cross:
            p["xattn"] = _attn_params(b, f"{pre}/xattn", n, cfg)
        p["ffn"] = _ffn_params(b, f"{pre}/ffn", n, d, cfg.d_ff, "gelu")
        return p

    def fn(b: ParamInit) -> Dict:
        p: Dict = {"embed": b.param("embed", (v, d))}
        if cfg.family == "moe":
            kd = cfg.first_k_dense
            if kd:
                p["dense_layers"] = stack(b, "dense_layers", kd)
                p["dense_layers"]["ffn"] = _ffn_params(
                    b, "dense_layers/ffn", kd, d, cfg.d_ff, cfg.act)
            p["layers"] = stack(b, "layers", L - kd)
            p["layers"]["moe"] = _moe_params(b, "layers/moe", L - kd, cfg)
        elif cfg.family == "ssm":
            p["layers"] = _rwkv_params(b, "layers", L, cfg)
        elif cfg.family == "encdec":
            p["enc_layers"] = whisper_stack(b, "enc_layers",
                                            cfg.n_enc_layers, cross=False)
            p["dec_layers"] = whisper_stack(b, "dec_layers", L, cross=True)
            p["enc_ln"] = b.param("enc_ln", (d,), "ones")
            p["enc_lnb"] = b.param("enc_lnb", (d,), "zeros")
            p["dec_pos"] = b.param("dec_pos", (32768, d))
        else:
            p["layers"] = stack(b, "layers", L)
            if cfg.family == "hybrid":
                p["layers"]["mamba"] = _mamba_params(b, "layers/mamba", L,
                                                     cfg)
            p["layers"]["ffn"] = _ffn_params(b, "layers/ffn", L, d, cfg.d_ff,
                                             cfg.act)
        p["final_norm"] = b.param("final_norm", (d,), "ones")
        if cfg.family == "encdec":
            p["final_normb"] = b.param("final_normb", (d,), "zeros")
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
                      window=0, rope=True, ring=False):
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
    below min(pos + 1, L) is valid (the window is the buffer's size).
    rope=False leaves q and k unrotated whatever cfg.rope_theta says."""
    b_, s, _ = x.shape
    assert s == 1
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.dim() == 1
    q, k, v = _qkv(lp, x, cfg)
    if rope and cfg.rope_theta:
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


def attn_block_decode_k(lp, x, cfg: ModelConfig, *, cache_k, cache_v, pos,
                        window=0):
    """Q-token verify attention against a cache (speculative decoding —
    serve/spec.py). x: (B,Q,D) holds the Q=k+1 candidate tokens per row;
    pos: (B,) per-row write offset of the FIRST candidate (the plain
    decode write position, so a round that accepts no draft writes the
    line plain decode would have). cache_k/v: (B,L,KvH,Hd), updated IN
    PLACE (the JAX version returns new arrays).

    Candidate j's k/v land on line pos + j, then one multi-query causal
    attention runs where candidate j sees cache positions <= pos + j.
    The JAX one-hot select drops a line past the cache end; so does this
    write, without a host sync: such a line is redirected to (pos + j) mod
    L, a line no other candidate of the row writes (Q <= L), and writes
    that line's own bytes back. Rejected candidates' lines stay beyond the
    rolled-back position, invisible and overwritten by the step that
    first reaches them."""
    b_, qn, _ = x.shape
    q, k, v = _qkv(lp, x, cfg)
    pos = torch.as_tensor(pos, device=x.device)
    lines = pos.long()[:, None] + torch.arange(qn, device=x.device)  # (B,Q)
    if cfg.rope_theta:
        q = apply_rope(q.transpose(1, 2), lines[:, None],
                       cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), lines[:, None],
                       cfg.rope_theta).transpose(1, 2)
    lcache = cache_k.shape[1]
    assert qn <= lcache, (qn, lcache)
    keep = (lines < lcache)[..., None, None]
    at = lines % lcache
    rows = torch.arange(b_, device=x.device)[:, None].expand(b_, qn)
    for cache, new in ((cache_k, k), (cache_v, v)):
        old = cache[rows, at]
        cache.index_put_((rows, at), torch.where(keep, new.to(cache.dtype),
                                                 old))
    out = attn_lib.decode_attention_multi(q, cache_k, cache_v, pos + qn,
                                          window=window)
    out = matmul_rp(out.reshape(b_, qn, -1), lp["wo"])
    return out, (cache_k, cache_v)


def attn_block_continue(lp, x, cfg: ModelConfig, *, cache_k, cache_v, slot,
                        start, positions):
    """Suffix attention for prefix-continue prefill (the paged K/V cache's
    prefix reuse). x: (1,S,D) suffix hidden states whose first token sits
    at absolute position `start`; cache_k/v: (B,Lcache,KvH,Hd) slot caches
    whose `slot` row already holds the first `start` K/V lines (restored
    prefix pages). positions: (S,) = start + arange(S).

    The suffix k/v are written into the slot row at `start` IN PLACE, and
    the queries attend against the whole row with q_offset=start
    (chunked_causal_attention: no flash on the suffix, as in the JAX
    package): keys past each query are causally masked, so lines beyond
    the written region get exact-0 weight. Returns (out, (cache_k,
    cache_v))."""
    b_, s, _ = x.shape
    assert b_ == 1
    q, k, v = _qkv(lp, x, cfg)
    if cfg.rope_theta:
        q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    cache_k[slot, start:start + s] = k[0].to(cache_k.dtype)
    cache_v[slot, start:start + s] = v[0].to(cache_v.dtype)
    out = attn_lib.chunked_causal_attention(
        q, cache_k[slot:slot + 1], cache_v[slot:slot + 1], q_offset=start)
    out = matmul_rp(out.reshape(b_, s, -1), lp["wo"])
    return out, (cache_k, cache_v)


def rwkv_time_mix(tm, x, shift_in, wkv_state, cfg: ModelConfig, *,
                  decode: bool):
    """RWKV6 time mix. x: (B,T,D) bf16; shift_in: (B,D), the previous
    segment's last input; wkv_state: (B,H,Hd,Hd) f32. Returns (out (B,T,D)
    bf16, x's last token (B,D), new wkv state).

    The WKV form by the reference's rule: decode runs wkv6_decode; a
    prefill or training segment runs wkv6_chunked at chunk 64 when
    T % 64 == 0, as one chunk of T when 1 < T < 64, and the sequential
    scan otherwise. The token-shift mix runs in bf16, every step rounded
    (the JAX package's code, compiled without excess precision); the LoRA
    and decay products in f32."""
    b_, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    x_prev, last = rwkv_lib.token_shift(x, shift_in)

    diff = x_prev - x
    xx = x + diff * tm["mu_x"].to(x.dtype)
    delta = torch.tanh(xx.float() @ tm["lora_a"].float())
    delta = delta.reshape(b_, t, 5, rwkv_lib.LORA_MIX)
    delta = torch.einsum("btsk,skd->btsd", delta,
                         tm["lora_b"].float()).to(x.dtype)
    mus = tm["mu_5"].to(x.dtype)                         # (5, D)
    x_r, x_k, x_v, x_w, x_g = (x + diff * (mus[i] + delta[:, :, i])
                               for i in range(5))

    r = matmul(x_r, tm["wr"]).reshape(b_, t, h, hd).float()
    k = matmul(x_k, tm["wk"]).reshape(b_, t, h, hd).float()
    v = matmul(x_v, tm["wv"]).reshape(b_, t, h, hd).float()
    g = torch.nn.functional.silu(matmul(x_g, tm["wg"]).float())

    wlog = tm["w0"].float() + (torch.tanh(x_w.float() @ tm["td_a"].float())
                               @ tm["td_b"].float())
    w = torch.exp(-torch.exp(wlog)).reshape(b_, t, h, hd)
    u = tm["u"].float()

    if decode:
        y, wkv_state = rwkv_lib.wkv6_decode(r[:, 0], k[:, 0], v[:, 0],
                                            w[:, 0], u, wkv_state)
        y = y[:, None]
    else:
        chunk = 64 if t % 64 == 0 else (t if t < 64 else 1)
        if chunk > 1:
            y, wkv_state = rwkv_lib.wkv6_chunked(r, k, v, w, u, wkv_state,
                                                 chunk=chunk)
        else:
            y, wkv_state = rwkv_lib.wkv6_scan(r, k, v, w, u, wkv_state)

    # per-head group norm (the population variance, as jnp.var), then the
    # gate and the output projection
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(b_, t, d) * tm["ln_x"].float()
    out = matmul((y * g).to(PARAM_DTYPE), tm["wo"])
    return out, last, wkv_state


def rwkv_channel_mix(cm, x, shift_in):
    """RWKV6 channel mix. x: (B,T,D) bf16; shift_in: (B,D). Returns (out
    (B,T,D) bf16, x's last token)."""
    x_prev, last = rwkv_lib.token_shift(x, shift_in)
    xk = x + (x_prev - x) * cm["mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * cm["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(matmul(xk, cm["wk"]).float()))
    kv = matmul(k.to(PARAM_DTYPE), cm["wv"])
    out = torch.sigmoid(matmul(xr, cm["wr"]).float()) * kv
    return out.to(PARAM_DTYPE), last


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
    setting. A gradient through the "pallas" scan raises
    NotImplementedError (`SsmScanNoGrad`)."""
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
        y, h_state = SsmScanNoGrad.apply(xs.float(), dt, bmat.contiguous(),
                                         cmat.contiguous(), mp["a_log"],
                                         mp["d"], h_state)
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


class SsmScanNoGrad(torch.autograd.Function):
    """The "pallas" scan (`_dispatch_ssm`) as an autograd node whose
    backward raises: the selective-scan kernel has no backward, as the
    JAX package's Pallas scan has none (its jax.grad fails to linearize
    it). The forward is the dispatch itself, one launch, whatever the
    device; under torch.no_grad (serving) no node is recorded."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a_log, d, h0):
        return _dispatch_ssm(x, dt, bmat, cmat, a_log, d, h0)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "ssm_impl='pallas': the selective-scan kernel (csrc/ssm_scan.cu) "
            "has no backward, as the JAX package's Pallas scan has none; "
            "train with ssm_impl='chunked' or 'scan'")


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
