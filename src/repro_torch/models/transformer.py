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

Every parameter carries the reference's logical axes (ParamInit.param's
third argument), which dist/sharding.py maps onto a mesh. Under
exact-TP (layers.exact_tp_scope) a rank holds column shards: `_qkv`
gives its own heads where the ctx's model axis divides both head counts
(`local_heads`) and gathers whole heads otherwise; `attn_block` runs the
flash kernel on those heads (the reference's `flash_attention_spmd` is
`attention.flash_attention` on a rank's heads here: one process a rank
needs no shard_map) and
`attn_block_decode` reads `ctx` for the seq-sharded decode cache
(`attention.flash_decode_sharded`). Training under the reference plan
over a model axis (`attn_block(tp=)`) holds row-parallel shards instead:
a rank's q/k/v columns and wo rows, the partial output summed over the
model group (`_qkv_row_parallel`). The moe FFN itself is
`models/moe.py`, the WKV forms `models/rwkv6.py`; whisper's encoder and
decoder stacks are in `models/registry.py`, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import copy_to
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.layers import (PARAM_DTYPE, ParamInit, apply_rope,
                                       gather_exact_tp, matmul, matmul_f32,
                                       matmul_rp)

# ===========================================================================
# parameter construction
# ===========================================================================

def _attn_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    col_q, col_kv = ("layers", "d_model", "heads"), ("layers", "d_model",
                                                      "kv_heads")
    p = {
        "wq": b.param(f"{pre}/wq", (L, d, h * hd), col_q),
        "wk": b.param(f"{pre}/wk", (L, d, kv * hd), col_kv),
        "wv": b.param(f"{pre}/wv", (L, d, kv * hd), col_kv),
        "wo": b.param(f"{pre}/wo", (L, h * hd, d),
                      ("layers", "heads", "d_model")),
    }
    if cfg.qkv_bias:
        p["bq"] = b.param(f"{pre}/bq", (L, h * hd), ("layers", "heads"),
                          "zeros")
        p["bk"] = b.param(f"{pre}/bk", (L, kv * hd), ("layers", "kv_heads"),
                          "zeros")
        p["bv"] = b.param(f"{pre}/bv", (L, kv * hd), ("layers", "kv_heads"),
                          "zeros")
    return p


def _ffn_params(b: ParamInit, pre: str, L: int, d: int, f: int, act: str
                ) -> Dict:
    """SwiGLU (wi, wg, wo) or, for any other act, whisper's gelu FFN (wi,
    bi, wo, bo; the biases zero)."""
    up, down = ("layers", "d_model", "d_ff"), ("layers", "d_ff", "d_model")
    if act == "swiglu":
        return {
            "wi": b.param(f"{pre}/wi", (L, d, f), up),
            "wg": b.param(f"{pre}/wg", (L, d, f), up),
            "wo": b.param(f"{pre}/wo", (L, f, d), down),
        }
    return {
        "wi": b.param(f"{pre}/wi", (L, d, f), up),
        "bi": b.param(f"{pre}/bi", (L, f), ("layers", "d_ff"), "zeros"),
        "wo": b.param(f"{pre}/wo", (L, f, d), down),
        "bo": b.param(f"{pre}/bo", (L, d), ("layers", "d_model"), "zeros"),
    }


def _moe_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d, e, f = cfg.d_model, cfg.n_experts, (cfg.moe_d_ff or cfg.d_ff)
    p = {
        "router": b.param(f"{pre}/router", (L, d, e),
                          ("layers", "d_model", None)),
        "wi": b.param(f"{pre}/wi", (L, e, d, f),
                      ("layers", "experts", "d_model", "d_ff")),
        "wg": b.param(f"{pre}/wg", (L, e, d, f),
                      ("layers", "experts", "d_model", "d_ff")),
        "wo": b.param(f"{pre}/wo", (L, e, f, d),
                      ("layers", "experts", "d_ff", "d_model")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = b.param(f"{pre}/shared_wi", (L, d, fs),
                                  ("layers", "d_model", "d_ff"))
        p["shared_wg"] = b.param(f"{pre}/shared_wg", (L, d, fs),
                                  ("layers", "d_model", "d_ff"))
        p["shared_wo"] = b.param(f"{pre}/shared_wo", (L, fs, d),
                                  ("layers", "d_ff", "d_model"))
    return p


def _rwkv_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    km, kd = rwkv_lib.LORA_MIX, rwkv_lib.LORA_DECAY
    f = cfg.d_ff
    vec = ("layers", "d_model")
    col = ("layers", "d_model", "heads")
    return {
        "ln1": b.param(f"{pre}/ln1", (L, d), vec, "ones"),
        "ln2": b.param(f"{pre}/ln2", (L, d), vec, "ones"),
        "tm": {
            "mu_x": b.param(f"{pre}/tm/mu_x", (L, d), vec),
            # the r, k, v, w and g streams' mus
            "mu_5": b.param(f"{pre}/tm/mu_5", (L, 5, d),
                            ("layers", None, "d_model")),
            "lora_a": b.param(f"{pre}/tm/lora_a", (L, d, 5 * km),
                              ("layers", "d_model", None)),
            "lora_b": b.param(f"{pre}/tm/lora_b", (L, 5, km, d),
                              ("layers", None, None, "d_model")),
            "td_a": b.param(f"{pre}/tm/td_a", (L, d, kd),
                            ("layers", "d_model", None)),
            "td_b": b.param(f"{pre}/tm/td_b", (L, kd, d),
                            ("layers", None, "d_model")),
            "w0": b.param(f"{pre}/tm/w0", (L, d), vec),
            "u": b.param(f"{pre}/tm/u", (L, h, hd), ("layers", "heads", None)),
            "wr": b.param(f"{pre}/tm/wr", (L, d, d), col),
            "wk": b.param(f"{pre}/tm/wk", (L, d, d), col),
            "wv": b.param(f"{pre}/tm/wv", (L, d, d), col),
            "wg": b.param(f"{pre}/tm/wg", (L, d, d), col),
            "wo": b.param(f"{pre}/tm/wo", (L, d, d),
                          ("layers", "heads", "d_model")),
            "ln_x": b.param(f"{pre}/tm/ln_x", (L, d), vec, "ones"),
        },
        "cm": {
            "mu_k": b.param(f"{pre}/cm/mu_k", (L, d), vec),
            "mu_r": b.param(f"{pre}/cm/mu_r", (L, d), vec),
            "wk": b.param(f"{pre}/cm/wk", (L, d, f),
                          ("layers", "d_model", "d_ff")),
            "wv": b.param(f"{pre}/cm/wv", (L, f, d),
                          ("layers", "d_ff", "d_model")),
            "wr": b.param(f"{pre}/cm/wr", (L, d, d),
                          ("layers", "d_model", "d_model")),
        },
    }


def _mamba_params(b: ParamInit, pre: str, L: int, cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    ci = 2 * d                      # d_inner
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)
    vec, ch = ("layers", "d_model"), ("layers", "heads")
    return {
        # xs | z side by side: a rank's shard keeps its block of each
        "in_proj": b.param(f"{pre}/in_proj", (L, d, 2 * ci),
                           ("layers", "d_model", "heads"), parts=2),
        "conv_w": b.param(f"{pre}/conv_w", (L, mamba_lib.CONV_K, ci),
                          ("layers", None, "heads")),
        "x_proj": b.param(f"{pre}/x_proj", (L, ci, dt_rank + 2 * n),
                          ("layers", "heads", None)),
        "dt_proj": b.param(f"{pre}/dt_proj", (L, dt_rank, ci),
                           ("layers", None, "heads")),
        # dt ~= softplus(-4.6) ~= 0.01 at init (the usual mamba dt range)
        "dt_bias": b.param(f"{pre}/dt_bias", (L, ci), ch, "const:-4.6"),
        "a_log": b.param(f"{pre}/a_log", (L, ci, n), ("layers", "heads", None),
                         "a_log"),
        "d": b.param(f"{pre}/d", (L, ci), ch, "ones"),
        "out_proj": b.param(f"{pre}/out_proj", (L, ci, d),
                            ("layers", "heads", "d_model")),
        "norm_attn": b.param(f"{pre}/norm_attn", (L, d), vec, "ones"),
        "norm_ssm": b.param(f"{pre}/norm_ssm", (L, d), vec, "ones"),
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
    vec = ("layers", "d_model")

    def stack(b: ParamInit, pre: str, n: int) -> Dict:
        return {"ln1": b.param(f"{pre}/ln1", (n, d), vec, "ones"),
                "ln2": b.param(f"{pre}/ln2", (n, d), vec, "ones"),
                "attn": _attn_params(b, f"{pre}/attn", n, cfg)}

    def whisper_stack(b: ParamInit, pre: str, n: int, cross: bool) -> Dict:
        norms = ("ln1", "lnx", "ln2") if cross else ("ln1", "ln2")
        p = {}
        for name in norms:
            p[name] = b.param(f"{pre}/{name}", (n, d), vec, "ones")
            p[f"{name}b"] = b.param(f"{pre}/{name}b", (n, d), vec, "zeros")
        p["attn"] = _attn_params(b, f"{pre}/attn", n, cfg)
        if cross:
            p["xattn"] = _attn_params(b, f"{pre}/xattn", n, cfg)
        p["ffn"] = _ffn_params(b, f"{pre}/ffn", n, d, cfg.d_ff, "gelu")
        return p

    def fn(b: ParamInit) -> Dict:
        p: Dict = {"embed": b.param("embed", (v, d), ("vocab", "d_model"))}
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
            p["enc_ln"] = b.param("enc_ln", (d,), ("d_model",), "ones")
            p["enc_lnb"] = b.param("enc_lnb", (d,), ("d_model",), "zeros")
            p["dec_pos"] = b.param("dec_pos", (32768, d), (None, "d_model"))
        else:
            p["layers"] = stack(b, "layers", L)
            if cfg.family == "hybrid":
                p["layers"]["mamba"] = _mamba_params(b, "layers/mamba", L,
                                                     cfg)
            p["layers"]["ffn"] = _ffn_params(b, "layers/ffn", L, d, cfg.d_ff,
                                             cfg.act)
        p["final_norm"] = b.param("final_norm", (d,), ("d_model",), "ones")
        if cfg.family == "encdec":
            p["final_normb"] = b.param("final_normb", (d,), ("d_model",),
                                       "zeros")
        if not cfg.tie_embeddings:
            p["head"] = b.param("head", (d, v), ("d_model", "vocab"))
        return p

    return fn


# ===========================================================================
# blocks (apply)
# ===========================================================================

def local_heads(cfg: ModelConfig, ctx) -> bool:
    """Whether attention runs on this rank's heads: under a ctx whose
    model axis divides both head counts (the reference's `hspec` rule,
    attention.py:253); then the rank's q heads and its kv heads form whole
    GQA groups."""
    return ctx is not None and ctx.tp_shards(cfg.n_heads,
                                             cfg.n_kv_heads) > 1


def _kv_heads(cfg: ModelConfig, ctx):
    """(first, total) of this rank's kv heads where `local_heads`, for the
    plain attention routes' `heads=`; None otherwise."""
    if not local_heads(cfg, ctx):
        return None
    return ctx.model_rank * cfg.n_kv_heads // ctx.model_size, cfg.n_kv_heads


def _qkv(lp, x, cfg: ModelConfig, ctx=None, *, whole: bool = False,
         kv_x=None):
    """q (B,S,H',Hd) of x, k and v (B,S',KvH',Hd) of kv_x (x itself by
    default; whisper's cross-attention passes the encoder output): H' and
    KvH' are this rank's heads where `local_heads(cfg, ctx)`, else every
    head. Under exact-TP the projections give this rank's columns; where
    the heads are not local those columns are gathered right after the
    projections (a column shard of wk may hold half a head: qwen2's 2 kv
    heads at TP 4), and attention then runs whole on every rank.
    whole=True gathers always (the seq-sharded decode cache needs every
    head)."""
    b_, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    hd = cfg.head_dim
    q = matmul(x, lp["wq"])
    k = matmul(kv_x, lp["wk"])
    v = matmul(kv_x, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    if whole or not local_heads(cfg, ctx):
        q = gather_exact_tp(q, cfg.n_heads * hd)
        k = gather_exact_tp(k, cfg.n_kv_heads * hd)
        v = gather_exact_tp(v, cfg.n_kv_heads * hd)
    elif q.shape[-1] * ctx.model_size != cfg.n_heads * hd:
        raise ValueError(f"exact-TP: wq gives {q.shape[-1]} columns, not "
                         f"this rank's {cfg.n_heads * hd // ctx.model_size}"
                         f" (pass the engine whole params; it cuts the "
                         f"shards)")
    s_kv = kv_x.shape[1]
    return (q.reshape(b_, s, -1, hd), k.reshape(b_, s_kv, -1, hd),
            v.reshape(b_, s_kv, -1, hd))


def _qkv_row_parallel(lp, x, cfg: ModelConfig, tp, kv_x=None):
    """q of x, k and v of kv_x (x itself by default; whisper's
    cross-attention passes the encoder output) under the reference
    training plan over the model group `tp` (spec_for splits wq/wk/wv's
    columns and wo's rows wherever the axis divides the dim, head-aligned
    or not), and the columns of the attention output this rank's wo rows
    take (None: its own heads').

    A projection whose weight is split gives this rank's columns of its
    input through CopyToGroup; one whose weight is whole is computed
    whole from the input itself. Where wq holds whole heads, attention
    runs on this rank's q heads: k and v are its kv heads where wk holds
    whole heads of the same GQA groups (Megatron's layout: nothing more),
    else they are made whole (a split projection's columns all-gathered,
    GatherDim; a whole one through CopyToGroup: each rank uses part of
    them) and cut to the kv heads of its q heads (a block of whole
    groups, the one kv head its q heads share, or one a q head). Where wq
    holds part of a head, q, k and v are all made whole, attention runs
    whole on every rank, and wo's rows take this rank's columns of its
    output."""
    from repro_torch.dist.collectives import GatherDim
    b_, s, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    s_kv = kv_x.shape[1]
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    xc = copy_to(x, tp)
    kvc = xc if kv_x is x else copy_to(kv_x, tp)

    def project(w, bias):
        src, src_c = (x, xc) if w == "wq" else (kv_x, kvc)
        split = lp[w].shape[-1] != (h if w == "wq" else kvh) * hd
        y = matmul(src_c if split else src, lp[w])
        if cfg.qkv_bias:
            y = y + lp[bias].to(y.dtype)
        return y, split

    def whole(y, split):
        return GatherDim.apply(y, y.dim() - 1, tp) if split else copy_to(
            y, tp)

    (q, _), (k, k_split), (v, _) = (project(w, b) for w, b in (
        ("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
    if q.shape[-1] % hd:                       # part of a head a rank
        first = tp.index * q.shape[-1]
        cols = (first, q.shape[-1])
        q = GatherDim.apply(q, q.dim() - 1, tp)
        k, v = whole(k, k_split), whole(v, k_split)
        return (q.reshape(b_, s, h, hd), k.reshape(b_, s_kv, kvh, hd),
                v.reshape(b_, s_kv, kvh, hd), cols)
    hl, g = q.shape[-1] // hd, h // kvh
    q = q.reshape(b_, s, hl, hd)
    if k_split and k.shape[-1] % hd == 0 and hl % g == 0 \
            and k.shape[-1] // hd == hl // g:
        return (q, k.reshape(b_, s_kv, -1, hd), v.reshape(b_, s_kv, -1, hd),
                None)
    k = whole(k, k_split).reshape(b_, s_kv, kvh, hd)
    v = whole(v, k_split).reshape(b_, s_kv, kvh, hd)
    q0 = tp.index * hl
    if hl % g == 0 or g % hl == 0:
        n = max(1, hl // g)
        return q, k.narrow(2, q0 // g, n), v.narrow(2, q0 // g, n), None
    idx = torch.div(q0 + torch.arange(hl, device=x.device), g,
                    rounding_mode="floor")
    return q, k.index_select(2, idx), v.index_select(2, idx), None


def attn_out_row_parallel(lp, out, cols, tp):
    """The output projection of attention run under `_qkv_row_parallel`:
    out (B,S,H',Hd) narrowed to `cols` where a rank holds part of a head,
    against this rank's wo rows, the partials summed over `tp`."""
    out = out.reshape(*out.shape[:2], -1)
    if cols is not None:
        out = out.narrow(-1, *cols)
    return matmul_rp(out, lp["wo"], tp)


def attn_block(lp, x, cfg: ModelConfig, *, positions, window=0,
               kv_valid=None, ctx=None, tp=None):
    """Full-sequence attention (prefill, training). Returns (out, (k, v)),
    k and v this rank's heads under exact-TP (see _qkv).

    positions: (S,) shared, or (B,S) per-row (left-padded prefill).
    kv_valid: optional (B,S) bool marking real (non-pad) key/value
    columns. ctx: the DistCtx of a sharded call (None on one device).
    tp: the model group where the reference training plan splits wo's
    rows over it (`DistCtx.row_parallel`): attention runs on this rank's
    heads, or whole where a rank holds part of a head
    (`_qkv_row_parallel`), wo's rows give this rank's partial of the
    output, and ReduceFromGroup sums the partials."""
    b_, s, _ = x.shape
    cols = None
    if tp is not None:
        q, k, v, cols = _qkv_row_parallel(lp, x, cfg, tp)
    else:
        q, k, v = _qkv(lp, x, cfg, ctx)
    if cfg.rope_theta:
        # (B,S) positions broadcast over the head axis of the (B,H,S,Hd)
        # rope input as (B,1,S)
        pos_r = positions if positions.dim() == 1 else positions[:, None]
        q = apply_rope(q.transpose(1, 2), pos_r, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pos_r, cfg.rope_theta).transpose(1, 2)
    if (cfg.use_flash_attention and window == 0 and s % 256 == 0
            and kv_valid is None):
        # the flash kernel (csrc/flash.cu) on this rank's heads: no (S,S)
        # score tensor ever reaches device memory; the same three
        # conditions as the JAX package (transformer.py:260-261)
        out = attn_lib.flash_attention(q, k, v, causal=True)
    else:
        out = attn_lib.chunked_causal_attention(
            q, k, v, window=window, kv_valid=kv_valid,
            heads=None if tp is not None else _kv_heads(cfg, ctx))
    if tp is not None:
        return attn_out_row_parallel(lp, out, cols, tp), (k, v)
    out = matmul_rp(out.reshape(b_, s, -1), lp["wo"])
    return out, (k, v)


def decode_heads_tp(y, total: int, hd: int, tp, local: bool):
    """A one-token projection (B,1,cols) under the training plan over the
    model group `tp` as heads (B,1,H',Hd): the rank's block of heads
    where `local` (the cache holds the rank's kv heads; a whole
    projection narrowed to them), else every head (a column-split
    projection's columns all-gathered over tp)."""
    if local:
        if y.shape[-1] == total * hd:
            per = y.shape[-1] // tp.size
            y = y.narrow(-1, tp.index * per, per)
    elif y.shape[-1] != total * hd:
        y = tp.all_gather(y, y.dim() - 1)
    return y.reshape(*y.shape[:2], -1, hd)


def out_rows_tp(wo, out, tp):
    """The output projection under the training plan's row-split wo: the
    attention output (B,S,H',Hd), narrowed to the columns of this rank's
    wo rows where it holds every head, times them; the partials summed
    over `tp`."""
    out = out.reshape(*out.shape[:2], -1)
    rows = wo.shape[-2]
    if out.shape[-1] != rows:
        out = out.narrow(-1, tp.index * rows, rows)
    return matmul_rp(out, wo, tp)


def _qkv_decode_tp(lp, x, cfg: ModelConfig, tp, local: bool):
    """q, k, v of one token (x (B,1,D)) under the training plan over the
    model group `tp` (`decode_heads_tp`): the rank's heads where `local`,
    else every head."""
    hd = cfg.head_dim
    q = matmul(x, lp["wq"])
    k = matmul(x, lp["wk"])
    v = matmul(x, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    return (decode_heads_tp(q, cfg.n_heads, hd, tp, local),
            decode_heads_tp(k, cfg.n_kv_heads, hd, tp, local),
            decode_heads_tp(v, cfg.n_kv_heads, hd, tp, local))


def attn_block_decode(lp, x, cfg: ModelConfig, *, cache_k, cache_v, pos,
                      window=0, rope=True, ring=False, ctx=None, tp=None):
    """One-token attention against a cache. cache_k/v: (B,L,KvH,Hd),
    updated IN PLACE (the JAX version returns new arrays); under exact-TP
    this rank's kv heads (see _qkv).

    pos is the write position — a 0-d tensor shared by all rows (lockstep
    decode) or a (B,) tensor when every row is at its own offset (the
    slot scheduler). The JAX per-row one-hot select becomes an indexed
    in-place write of each row's line (index_put_), and the shared-pos
    dynamic_update_slice an index_copy_; both stay on the device. pos must
    lie inside the cache (the engine's admission guarantees it), unless
    ring: then the cache is a ring buffer of the last L positions (the
    hybrid family's sliding window), the line is pos % L, and every line
    below min(pos + 1, L) is valid (the window is the buffer's size).
    rope=False leaves q and k unrotated whatever cfg.rope_theta says.

    ctx.kv_seq_shard with a shared pos (the reference's branch,
    transformer.py:311-313): the cache's seq dim is split over the model
    axis, this rank holding lines [r L, (r + 1) L) of it; the line is
    written only by the rank that holds it, and flash_decode_sharded
    combines every rank's partial softmax over whole heads.

    tp: the model group where the training plan (the decode step of
    train/step.py over a model axis) splits wo's rows over it: q, k and v
    are the rank's heads where the cache holds its kv heads, else every
    head (`_qkv_decode_tp`), and wo's rows take their columns of the
    output, the partials summed over tp (`out_rows_tp`)."""
    b_, s, _ = x.shape
    assert s == 1
    pos = torch.as_tensor(pos, device=x.device)
    per_row = pos.dim() == 1
    seq_shard = (ctx is not None and ctx.kv_seq_shard and not per_row
                 and not ring)
    if tp is not None:
        local = not seq_shard and cache_k.shape[2] < cfg.n_kv_heads
        q, k, v = _qkv_decode_tp(lp, x, cfg, tp, local)
    else:
        q, k, v = _qkv(lp, x, cfg, ctx, whole=seq_shard)
    heads = None if tp is not None else _kv_heads(cfg, ctx)
    if rope and cfg.rope_theta:
        # scalar pos -> one shared position; vector pos -> (B,1,1) so the
        # angle table broadcasts over heads per row
        pvec = pos[:, None, None] if per_row else pos.reshape(1)
        q = apply_rope(q.transpose(1, 2), pvec, cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pvec, cfg.rope_theta).transpose(1, 2)
    lcache = cache_k.shape[1]
    line = pos.long() % lcache if ring else pos.long()
    if seq_shard:
        line = line - ctx.model_rank * lcache
        mine = (line >= 0) & (line < lcache)
        line = line.clamp(0, lcache - 1).reshape(1)
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache.index_copy_(1, line, torch.where(
                mine, new.to(cache.dtype), cache.index_select(1, line)))
    elif per_row:
        rows = torch.arange(b_, device=x.device)
        cache_k.index_put_((rows, line), k[:, 0])
        cache_v.index_put_((rows, line), v[:, 0])
    else:
        cache_k.index_copy_(1, line.reshape(1), k)
        cache_v.index_copy_(1, line.reshape(1), v)
    if ring:
        out = attn_lib.decode_attention(q, cache_k, cache_v,
                                        torch.clamp_max(pos + 1, lcache),
                                        heads=heads)
    elif seq_shard:
        out = attn_lib.flash_decode_sharded(q, cache_k, cache_v, pos + 1,
                                            ctx=ctx, window=window)
    else:
        out = attn_lib.decode_attention(q, cache_k, cache_v, pos + 1,
                                        window=window, heads=heads)
    if tp is not None:
        return out_rows_tp(lp["wo"], out, tp), (cache_k, cache_v)
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


def _rank_block(local: int, whole: int, ctx, what: str) -> int:
    """The first index of this rank's block of `local` of `whole` along a
    dim the model axis splits (0 when the dim is whole)."""
    if local == whole:
        return 0
    if ctx is None or local * ctx.model_size != whole:
        raise ValueError(f"exact-TP: {local} {what} where the model has "
                         f"{whole} (pass the engine whole params; it cuts "
                         f"the shards)")
    return ctx.model_rank * local


def rwkv_time_mix(tm, x, shift_in, wkv_state, cfg: ModelConfig, *,
                  decode: bool, ctx=None, tp=None):
    """RWKV6 time mix. x: (B,T,D) bf16; shift_in: (B,D), the previous
    segment's last input; wkv_state: (B,H',Hd,Hd) f32. Returns (out (B,T,D)
    bf16, x's last token (B,D), new wkv state).

    The WKV form by the reference's rule: decode runs wkv6_decode; a
    prefill or training segment runs wkv6_chunked at chunk 64 when
    T % 64 == 0, as one chunk of T when 1 < T < 64, and the sequential
    scan otherwise. The token-shift mix runs in bf16, every step rounded
    (the JAX package's code, compiled without excess precision); the LoRA
    and decay products in f32.

    Under exact-TP (ctx) wr/wk/wv/wg give this rank's columns: where the
    model axis divides the heads, r, k, v and g are the rank's H' heads,
    the decay w (from the whole td_a/td_b), u and ln_x are computed or
    taken whole and sliced to them, the WKV state holds them, the WKV form
    runs them inside every head's products (zeros at the others), and
    y * g is gathered before the whole wo (matmul_rp); where it does not,
    the four are gathered to every head right after their products and
    the mix runs whole.

    tp: the model group where the training plan splits tm/wo's rows over
    it (tensor-parallel training, whole heads a rank): r, k, v and g are
    the rank's heads from CopyToGroup of x_r/x_k/x_v/x_g, the decay is
    computed whole and narrowed to them (through CopyToGroup, so the whole
    td_a/td_b get every rank's part of the grad), u is the rank's block,
    ln_x is whole and sliced (CopyToGroup too), the WKV form runs the
    rank's heads alone (training is held in tolerance, not in bits), and
    tm/wo's partials are summed over the group."""
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

    r, k, v, g = (matmul(copy_to(xi, tp), tm[name]) for xi, name in (
        (x_r, "wr"), (x_k, "wk"), (x_v, "wv"), (x_g, "wg")))
    dl = r.shape[-1]                     # this rank's columns, whole heads
    if tp is not None:
        first = tp.index * dl
    else:
        if ctx is None or ctx.tp_shards(h) == 1:
            r, k, v, g = (gather_exact_tp(a, d) for a in (r, k, v, g))
            dl = r.shape[-1]
        first = _rank_block(dl, d, ctx, "time-mix columns")
    if dl % hd:
        raise ValueError(f"{dl} time-mix columns a rank: not whole heads "
                         f"of {hd}")
    hl = dl // hd
    r, k, v = (a.reshape(b_, t, hl, hd).float() for a in (r, k, v))
    g = torch.nn.functional.silu(g.float())

    wlog = tm["w0"].float() + (torch.tanh(x_w.float() @ tm["td_a"].float())
                               @ tm["td_b"].float())
    w = copy_to(torch.exp(-torch.exp(wlog)), tp).reshape(b_, t, h, hd)
    w = w.narrow(2, first // hd, hl)
    u = tm["u"].float()
    if u.shape[0] != hl:                 # whole under exact-TP
        u = u.narrow(0, first // hd, hl)

    # under exact-TP a rank's heads run inside every head's batched
    # products, zeros at the others (attention._f32_heads): cuBLAS picks
    # the batched kernel by the batch count, and the sequential scan's
    # einsum over 32 of rwkv6-7b's 64 heads is not those heads of the
    # whole (tools/tp_exactness_probe.py --families)
    heads = None if hl == h or tp is not None else (first // hd, h)
    r, k, v, w = (attn_lib._f32_heads(a, 2, heads) for a in (r, k, v, w))
    u = attn_lib._f32_heads(u, 0, heads)
    state = attn_lib._f32_heads(wkv_state, 1, heads)
    if decode:
        y, state = rwkv_lib.wkv6_decode(r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                        u, state)
        y = y[:, None]
    else:
        chunk = 64 if t % 64 == 0 else (t if t < 64 else 1)
        if chunk > 1:
            y, state = rwkv_lib.wkv6_chunked(r, k, v, w, u, state,
                                             chunk=chunk)
        else:
            y, state = rwkv_lib.wkv6_scan(r, k, v, w, u, state)
    y = attn_lib._own_heads(y, 2, heads, hl)
    wkv_state = attn_lib._own_heads(state, 1, heads, hl)

    # per-head group norm (the population variance, as jnp.var), then the
    # gate and the output projection
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    ln_x = copy_to(tm["ln_x"], tp).float().narrow(0, first, dl)
    y = y.reshape(b_, t, dl) * ln_x
    out = matmul_rp((y * g).to(PARAM_DTYPE), tm["wo"], tp)
    return out, last, wkv_state


def rwkv_channel_mix(cm, x, shift_in, tp=None):
    """RWKV6 channel mix. x: (B,T,D) bf16; shift_in: (B,D). Returns (out
    (B,T,D) bf16, x's last token). Under exact-TP cm/wk gives this rank's
    d_ff columns, gathered before the whole cm/wv (matmul_rp); cm/wr is
    whole. tp: the model group where the training plan splits d_ff over
    it: cm/wk's columns behind CopyToGroup, cm/wv's partials summed over
    the group, the whole cm/wr's sigmoid gate on the sum."""
    x_prev, last = rwkv_lib.token_shift(x, shift_in)
    xk = x + (x_prev - x) * cm["mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * cm["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(matmul(copy_to(xk, tp), cm["wk"]).float()))
    kv = matmul_rp(k.to(PARAM_DTYPE), cm["wv"], tp)
    out = torch.sigmoid(matmul(xr, cm["wr"]).float()) * kv
    return out.to(PARAM_DTYPE), last


def mamba_path(mp, x, cfg: ModelConfig, *, conv_state=None, h_state=None,
               decode: bool = False, ctx=None, tp=None):
    """Mamba selective-SSM path of the Hymba block. x: (B,T,D) bf16.
    Returns (y (B,T,D) bf16, new conv state (B,K-1,Ci') bf16, new h state
    (B,Ci',N) f32), Ci' = Ci = 2 D on one device.

    The scan by cfg.ssm_impl, as the JAX package: "pallas" dispatches the
    registry's "ssm" kernel (csrc/ssm_scan.cu on the card) with an SsmKey
    of this (B, T, Ci', N) and a model-only blk_c, as flash's
    `_dispatch_flash` (no timing pass on the model path); "chunked" runs
    ssm_chunked at chunk 64 when T % 64 == 0 and the sequential scan
    otherwise; "scan" the sequential scan; "stub" (prefill only) skips the
    scan and keeps the projections. Decode runs ssm_decode whatever the
    setting. A gradient through the "pallas" scan raises
    NotImplementedError (`SsmScanNoGrad`).

    Under exact-TP (ctx) a rank holds Ci' = Ci / tp channels. in_proj's
    shard packs the rank's block of xs beside its block of z (ParamInit
    parts=2, dist/sharding.local_shard), so the local chunk gives both;
    conv_w, dt_proj, dt_bias and d are split with the channels and used as
    they are; a_log is whole and the rank takes its rows; x_proj and
    out_proj contract over the channels and are whole, so xs and y are
    gathered first (matmul_rp): proj (hence dt's input, B and C) and the
    output are computed whole on every rank, in the one-device order. The
    in_proj and f32 dt products give the rank's columns of the whole
    width's product (layers.matmul, matmul_f32: `_column_product`). The
    conv and h states hold the rank's channels. The "pallas" scan keys its
    config on the local channels, as the reference does; its states a
    thread set the order of y's sum, and the model picks the same at
    hymba's Ci and Ci / 2 (tools/tp_exactness_probe.py --families; phase
    17e and tests/test_torch_serve_tp.py hold the picks equal).

    tp: the model group where the training plan splits out_proj's rows
    (the channels) over it (tensor-parallel training): the same packed
    in_proj block behind CopyToGroup, conv_w, dt_proj, dt_bias, d and
    a_log the rank's channels; x_proj is row-parallel, its partials
    summed over the group (proj, whole, then enters the rank's channels
    through CopyToGroup: dt's input, B and C), and so is out_proj."""
    b_, t, d = x.shape
    ci = 2 * d
    n = cfg.ssm_state
    dt_rank = max(1, d // 16)

    xz = matmul(copy_to(x, tp), mp["in_proj"])            # (B,T,2Ci')
    xs, z = torch.chunk(xz, 2, dim=-1)
    cl = xs.shape[-1]
    xs, conv_state = mamba_lib.causal_conv1d(xs, mp["conv_w"], conv_state)
    xs = torch.nn.functional.silu(xs.float()).to(PARAM_DTYPE)

    proj = copy_to(matmul_rp(xs, mp["x_proj"], tp), tp).float()
    dt_in, bmat, cmat = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = torch.nn.functional.softplus(matmul_f32(dt_in, mp["dt_proj"])
                                      + mp["dt_bias"].float())
    a_log = mp["a_log"]
    if a_log.shape[0] != cl:                     # whole under exact-TP
        a_log = a_log.narrow(0, _rank_block(cl, ci, ctx, "mamba channels"),
                             cl)

    if h_state is None:
        h_state = torch.zeros((b_, cl, n), dtype=torch.float32,
                              device=x.device)
    if cfg.ssm_impl == "stub" and not decode:
        y = xs.float() * mp["d"].float()
        y = y * torch.nn.functional.silu(z.float())
        return (matmul_rp(y.to(PARAM_DTYPE), mp["out_proj"], tp),
                conv_state, h_state)
    if decode:
        y, h_state = mamba_lib.ssm_decode(
            xs[:, 0].float(), dt[:, 0], bmat[:, 0], cmat[:, 0], a_log,
            mp["d"], h_state)
        y = y[:, None]
    elif cfg.ssm_impl == "pallas":
        y, h_state = SsmScanNoGrad.apply(xs.float(), dt, bmat.contiguous(),
                                         cmat.contiguous(), a_log,
                                         mp["d"], h_state)
    else:
        chunk = 64 if (t % 64 == 0 and cfg.ssm_impl == "chunked") else 1
        if chunk > 1:
            y, h_state = mamba_lib.ssm_chunked(
                xs.float(), dt, bmat, cmat, a_log, mp["d"], h_state,
                chunk=chunk)
        else:
            y, h_state = mamba_lib.ssm_scan(
                xs.float(), dt, bmat, cmat, a_log, mp["d"], h_state)

    y = y * torch.nn.functional.silu(z.float())
    out = matmul_rp(y.to(PARAM_DTYPE), mp["out_proj"], tp)
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
    SsmKey(B, T, Ci', N) of this call's channels (a rank's under exact-TP,
    as the reference keys it on the local channel shard,
    transformer.py:492); a shape the tune menu cannot tile resolves to the
    clamped static config."""
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
