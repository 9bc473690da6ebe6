"""Attention — the port of `repro.models.attention` (:30-157, :264-275):
chunked attention for prefill (causal, or bidirectional for whisper's
encoder and cross-attention), single-token and multi-query decode
attention, and the flash-kernel route through the registry.

Memory design as in the JAX package: the plain prefill path never holds
more than one (chunk x S) score block a head group; the flash route
(`cfg.use_flash_attention`) keeps its score tiles on chip altogether
(csrc/flash.cu). Scores and softmax are f32; probabilities are cast to
bf16 before the value product, which accumulates in f32 — the JAX
einsums with preferred_element_type=f32, written as f32 products of
bf16-valued operands.

`flash_decode_sharded` waits for the mesh slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import PARAM_DTYPE

NEG_INF = -1e30


def _gqa_reshape(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,Hd) -> (B,S,KvH,G,Hd)"""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, hd)


def chunked_causal_attention(q, k, v, *, chunk: int = 512, window: int = 0,
                             q_offset: int = 0, causal: bool = True,
                             kv_valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """q: (B,Sq,H,Hd), k/v: (B,Skv,KvH,Hd). Causal by default; causal=False
    is full bidirectional attention (whisper's encoder and
    cross-attention), where window and q_offset play no part. window:
    sliding-window width (0 = none). q_offset: absolute position of q[0]
    relative to k[0]. kv_valid: optional (B,Skv) bool — False columns
    (padding) are masked out of every query's softmax. Queries run in
    chunks (the JAX scan) so one (chunk x Skv) score block is live; a
    length the chunk does not divide runs in its largest divisor below
    the chunk (whisper's 1500 frames in chunks of 500)."""
    b, sq, h, hd = q.shape
    _, skv, n_kv, _ = k.shape
    scale = hd ** -0.5
    qr = _gqa_reshape(q, n_kv)                        # (B,Sq,KvH,G,Hd)
    chunk = min(chunk, sq)
    if sq % chunk:
        chunk = max(c for c in range(1, chunk + 1) if sq % c == 0)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(skv, device=q.device)
    outs = []
    for c0 in range(0, sq, chunk):
        qc = qr[:, c0:c0 + chunk].float()
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
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0
                     ) -> torch.Tensor:
    """Single-token decode. q: (B,1,H,Hd); caches: (B,L,KvH,Hd).
    cache_len: valid cache positions — a scalar (int or 0-d tensor)
    shared by every row, or a (B,) tensor of per-row lengths (the slot
    scheduler, where each slot is at its own offset)."""
    b, _, h, hd = q.shape
    _, lc, n_kv, _ = k_cache.shape
    g = h // n_kv
    scale = hd ** -0.5
    qr = q.reshape(b, n_kv, g, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) * scale
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
    out = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(PARAM_DTYPE)


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


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """The flash kernel on q: (B,S,H,Hd), k/v: (B,S,KvH,Hd) — the
    `ctx=None` branch of the JAX `flash_attention_spmd` (:244-245)."""
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
