"""The dense decoder's blocks — the port of the dense parts of
`repro.models.transformer`: parameter construction (`_attn_params`,
`_ffn_params`, the dense branch of `build_param_fn`, :45-76, :150-163,
:217-222), `_qkv` (:231), `attn_block` (:245) and `attn_block_decode`
(:276, the scalar-pos and per-row branches).

The other families' blocks (moe, rwkv, mamba/hymba, whisper, vlm), the
ring-buffer and sharded-decode branches of `attn_block_decode`,
`attn_block_decode_k` and `attn_block_continue` wait for their slices.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import ParamInit, apply_rope, matmul, matmul_rp


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


def build_param_fn(cfg: ModelConfig) -> Callable[[ParamInit], Dict]:
    """A function of a ParamInit that makes the dense param tree for cfg,
    with the JAX tree's keys, shapes and draw order."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port serves the "
            "dense family (ROADMAP queue 1, item 8 lists the others)")
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers

    def fn(b: ParamInit) -> Dict:
        p: Dict = {"embed": b.param("embed", (v, d))}
        p["layers"] = {
            "ln1": b.param("layers/ln1", (L, d), "ones"),
            "ln2": b.param("layers/ln2", (L, d), "ones"),
            "attn": _attn_params(b, "layers/attn", L, cfg),
            "ffn": _ffn_params(b, "layers/ffn", L, d, cfg.d_ff, cfg.act),
        }
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
                      window=0):
    """One-token attention against a cache. cache_k/v: (B,L,KvH,Hd),
    updated IN PLACE (the JAX version returns new arrays).

    pos is the write position — a 0-d tensor shared by all rows (lockstep
    decode) or a (B,) tensor when every row is at its own offset (the
    slot scheduler). The JAX per-row one-hot select becomes an indexed
    in-place write of each row's line (index_put_), and the shared-pos
    dynamic_update_slice an index_copy_; both stay on the device. pos must
    lie inside the cache (the engine's admission guarantees it)."""
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
    line = pos.long()
    if per_row:
        rows = torch.arange(b_, device=x.device)
        cache_k.index_put_((rows, line), k[:, 0])
        cache_v.index_put_((rows, line), v[:, 0])
    else:
        cache_k.index_copy_(1, line.reshape(1), k)
        cache_v.index_copy_(1, line.reshape(1), v)
    out = attn_lib.decode_attention(q, cache_k, cache_v, pos + 1,
                                    window=window)
    out = matmul_rp(out.reshape(b_, 1, -1), lp["wo"])
    return out, (cache_k, cache_v)
