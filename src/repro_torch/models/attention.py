"""Attention — the port of `repro.models.attention` (:30-275): chunked
attention for prefill (causal, or bidirectional for whisper's encoder and
cross-attention), single-token and multi-query decode attention, the
flash-kernel route through the registry, and the distributed flash-decode
over a seq-sharded cache (`flash_decode_sharded`, `_partial_decode`).

Memory design as in the JAX package: the plain prefill path never holds
more than one (chunk x S) score block a head group; the flash route
(`cfg.use_flash_attention`) keeps its score tiles on chip altogether
(csrc/flash.cu). Scores and softmax are f32; probabilities are cast to
bf16 before the value product, which accumulates in f32 — the JAX
einsums with preferred_element_type=f32, written as f32 products of
bf16-valued operands.

Explicit SPMD: a sharded call runs in one process a rank, so the
tensors here are already the rank's. The reference's
`flash_attention_spmd` is `flash_attention` on this rank's heads as
`transformer._qkv` gives them (no shard_map is needed to keep the kernel
on local shards, and its FlashKey is the local problem's); the plain
routes take `heads=` and compute a rank's heads inside the whole head
count's batched products (`_f32_heads`), so they keep the one-device
bits; `flash_decode_sharded` combines the ranks' partial
softmax stats with `torch.distributed.all_reduce` over the model axis's
group (max, then two sums), the classic flash-decoding combine.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import PARAM_DTYPE

NEG_INF = -1e30


def _f32_heads(t: torch.Tensor, ax: int, heads=None) -> torch.Tensor:
    """t in f32 as an operand of a batched attention product whose kv-head
    axis is `ax`.

    heads=(first, total): t holds kv heads [first, first + n) of `total`
    (a rank's heads under exact-TP) and comes back with all `total` heads,
    its own at their places and zeros at the others. Each of the rank's
    heads is then computed at the same batch index of a product of the
    same shape as in the one-device call over every head, so it keeps
    that call's bits (`_own_heads` takes them back out). A batched product
    over only this rank's heads would not, nor would one product a kv
    head: on the card their f32 scores differ from the whole call's
    (~7.6e-6, tools/tp_exactness_probe.py)."""
    if heads is None:
        return t.float()
    first, total = heads
    full = t.new_zeros(t.shape[:ax] + (total,) + t.shape[ax + 1:],
                       dtype=torch.float32)
    full.narrow(ax, first, t.shape[ax]).copy_(t)
    return full


def _own_heads(t: torch.Tensor, ax: int, heads, n: int) -> torch.Tensor:
    """The rank's n kv heads of a result computed over `_f32_heads`'
    padded operands (t itself where heads is None)."""
    return t if heads is None else t.narrow(ax, heads[0], n)


def _gqa_reshape(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,Hd) -> (B,S,KvH,G,Hd)"""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def chunked_causal_attention(q, k, v, *, chunk: int = 512, window: int = 0,
                             q_offset: int = 0, causal: bool = True,
                             kv_valid: Optional[torch.Tensor] = None,
                             heads=None) -> torch.Tensor:
    """q: (B,Sq,H,Hd), k/v: (B,Skv,KvH,Hd). Causal by default; causal=False
    is full bidirectional attention (whisper's encoder and
    cross-attention), where window and q_offset play no part. window:
    sliding-window width (0 = none). q_offset: absolute position of q[0]
    relative to k[0]. kv_valid: optional (B,Skv) bool — False columns
    (padding) are masked out of every query's softmax. Queries run in
    chunks (the JAX scan) so one (chunk x Skv) score block is live; a
    length the chunk does not divide runs in its largest divisor below
    the chunk (whisper's 1500 frames in chunks of 500). heads=(first,
    total): q, k and v hold kv heads [first, first + KvH) of total (and
    their q heads), a rank's under exact-TP (`_f32_heads`)."""
    b, sq, h, hd = q.shape
    _, skv, n_kv, _ = k.shape
    scale = hd ** -0.5
    qr = _gqa_reshape(q, n_kv)                        # (B,Sq,KvH,G,Hd)
    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = max(c for c in range(1, chunk + 1) if sq % c == 0)
    kf, vf = _f32_heads(k, 2, heads), _f32_heads(v, 2, heads)
    kv_pos = torch.arange(skv, device=q.device)
    outs = []
    for c0 in range(0, sq, chunk):
        qc = _f32_heads(qr[:, c0:c0 + chunk], 2, heads)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qc, kf) * scale
        if causal:
            q_pos = q_offset + c0 + torch.arange(chunk, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= kv_pos[None, :] > (q_pos[:, None] - window)
            scores = torch.where(mask, scores, NEG_INF)
        if kv_valid is not None:
            scores = torch.where(kv_valid[:, None, None, None, :], scores,
                                 NEG_INF)
        p = torch.softmax(scores, dim=-1).to(PARAM_DTYPE)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p.float(), vf
                                 ).to(PARAM_DTYPE))
    out = _own_heads(torch.cat(outs, dim=1), 2, heads, n_kv)
    return out.reshape(b, sq, h, hd)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     heads=None) -> torch.Tensor:
    """Single-token decode. q: (B,1,H,Hd); caches: (B,L,KvH,Hd).
    cache_len: valid cache positions — a scalar (int or 0-d tensor)
    shared by every row, or a (B,) tensor of per-row lengths (the slot
    scheduler, where each slot is at its own offset). heads=(first,
    total): the caches hold kv heads [first, first + KvH) of total, a
    rank's under exact-TP (`_f32_heads`)."""
    b, _, h, hd = q.shape
    _, lc, n_kv, _ = k_cache.shape
    g = h // n_kv
    scale = hd ** -0.5
    qr = _f32_heads(q.reshape(b, n_kv, g, hd), 1, heads)
    scores = torch.einsum("bkgd,bskd->bkgs", qr,
                          _f32_heads(k_cache, 2, heads)) * scale
    pos = torch.arange(lc, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.dim() == 1:                                   # per-row lengths
        mask = pos[None, :] < clen[:, None]               # (B, L)
        if window:
            mask &= pos[None, :] >= (clen[:, None] - window)
        scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    else:
        mask = pos < clen
        if window:
            mask &= pos >= (clen - window)
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(PARAM_DTYPE)
    out = torch.einsum("bkgs,bskd->bkgd", p.float(),
                       _f32_heads(v_cache, 2, heads))
    return _own_heads(out, 1, heads, n_kv).to(PARAM_DTYPE).reshape(
        b, 1, h, hd)


def decode_attention_multi(q, k_cache, v_cache, cache_len, *,
                           window: int = 0) -> torch.Tensor:
    """Multi-query decode: Q=k+1 candidate tokens per row attend against a
    cache whose last Q lines are the candidates themselves (speculative
    verify). q: (B,Q,H,Hd); caches: (B,L,KvH,Hd). cache_len counts valid
    positions INCLUDING the Q candidate lines, so candidate j sits at
    absolute position cache_len - Q + j and sees every cache position <=
    its own. cache_len: scalar or (B,) per-row."""
    b, qn, h, hd = q.shape
    _, lc, n_kv, _ = k_cache.shape
    g = h // n_kv
    scale = hd ** -0.5
    qr = q.reshape(b, qn, n_kv, g, hd).permute(0, 2, 3, 1, 4).float()
    scores = torch.einsum("bkgqd,bskd->bkgqs", qr, k_cache.float()) * scale
    pos = torch.arange(lc, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    if clen.dim() == 0:
        clen = clen.expand(b)
    q_pos = clen[:, None] - qn + torch.arange(qn, device=q.device)[None, :]
    mask = pos[None, None, :] <= q_pos[:, :, None]             # (B,Q,L)
    if window:
        mask &= pos[None, None, :] > (q_pos[:, :, None] - window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(PARAM_DTYPE)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.float(), v_cache.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, qn, h, hd)
    return out.to(PARAM_DTYPE)


# ---------------------------------------------------------------------------
# distributed flash-decode: seq-sharded KV cache + logsumexp-combine
# ---------------------------------------------------------------------------

def _partial_decode(q, k_shard, v_shard, valid_mask):
    """Partial attention over a KV shard -> (o unnormalized, l, m), f32.
    q: (B,KvH,G,Hd); k/v_shard: (B,Ls,KvH,Hd); valid_mask: (B,Ls) bool."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(),
                          k_shard.float()) * scale
    scores = torch.where(valid_mask[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1)                                      # (B,KvH,G)
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)                                            # (B,KvH,G)
    o = torch.einsum("bkgs,bskd->bkgd", e, v_shard.float())     # unnormalized
    return o, l, m


def flash_decode_sharded(q, k_cache, v_cache, cache_len, *, ctx,
                         window: int = 0) -> torch.Tensor:
    """Decode attention with the cache's seq dim split over ctx.model_axis.

    q: (B,1,H,Hd), every head, the same on every rank; k/v_cache: this
    rank's (B, L/mp, KvH, Hd) block, rank r holding positions
    [r L/mp, (r + 1) L/mp). cache_len: valid positions, a scalar (or a
    (B,) vector). Each rank computes the partial (o, l, m) over its block;
    the global softmax comes back from an all_reduce MAX of m, then
    all_reduce SUMs of l and o rescaled by exp(m - m_max), as the
    reference's pmax and two psums, over the model axis's AxesGroup
    (`ctx.model_group()`: counted in its `counts`, and run on an abstract
    mesh). A rank whose block holds no valid position contributes
    exp(-1e30 - m_max) = 0."""
    b, _, h, hd = q.shape
    _, ls, n_kv, _ = k_cache.shape
    g = h // n_kv
    pos = ctx.model_rank * ls + torch.arange(ls, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    clen = clen.expand(b) if clen.dim() == 0 else clen
    mask = pos[None, :] < clen[:, None]
    if window:
        mask &= pos[None, :] >= (clen[:, None] - window)
    o, lsum, m = _partial_decode(q.reshape(b, n_kv, g, hd), k_cache,
                                 v_cache, mask)
    # a group of one rank (no model axis larger than 1): the whole cache,
    # and each all_reduce a copy
    group = ctx.model_group()
    m_glob = group.all_reduce(m, op="max")
    corr = torch.exp(m - m_glob)
    l_glob = group.all_reduce(lsum * corr)
    o_glob = group.all_reduce(o * corr[..., None])
    out = o_glob / torch.clamp_min(l_glob[..., None], 1e-30)
    return out.reshape(b, 1, h, hd).to(PARAM_DTYPE)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The flash kernel on q: (B,S,H,Hd), k/v: (B,S,KvH,Hd): the JAX
    `flash_attention_spmd` (:227), whose shard_map puts the kernel on a
    device's local heads; here a rank's q, k and v are its heads already
    (`transformer._qkv`)."""
    return _dispatch_flash(q, k, v, causal)


def _dispatch_flash(q, k, v, causal):
    """Registry dispatch with a model-only tuned config (no timing pass on
    the model path, as in the JAX package); shapes the tune menu cannot
    tile fall back to config=None, which dispatch resolves to the
    divisor-clamped static config."""
    from repro_torch.kernels import api
    from repro_torch.tune import tuner
    key = api.get_kernel("flash").problem_key(q, k, v, causal=causal)
    try:
        cfg = tuner.tune_kernel("flash", key, measure_mode=False,
                                device=q.device).config
    except ValueError:            # empty config space at this shape
        cfg = None
    return api.dispatch("flash", q, k, v, causal=causal, config=cfg,
                        device=q.device)
