"""Paged decode attention, plain PyTorch — the port of
`repro.kernels.paged.paged` (:50-241). These are the plain versions the
CUDA kernels (csrc/paged_decode.cu through paged_cuda.py) are held
against, and what a wrapper runs for CPU tensors.

  q            (B, H, Hd)            one decode token per row, OR
               (B, Q, H, Hd)         Q = k+1 verify queries per row
                                     (query j sits at position
                                     cache_len - Q + j)
  kpool/vpool  (P, page, KvH, Hd)    the page pool (bf16; int8 + (P,)
                                     f32 scales for the quantized route)
  block_table  (B, npt) int32        page ids per row, in context order
                                     (entries past the valid length may
                                     be any in-range id — masking wins)
  cache_len    (B,) int32            valid context tokens per row

Versions, reference -> blockwise:

  * `paged_decode_ref`    — gather the whole table, then the serving
    path's own decode attention (`models.attention`), rank-polymorphic
    over q: the oracle.
  * `paged_decode_gather` — a loop over blocks of `pages_per_block`
    pages with an online-softmax accumulator (m, l, acc in f32).
  * `paged_decode_int8`   — the same loop over an int8 pool: each
    gathered page times its per-page scale before the contraction.
  * `paged_decode_verify` — Q queries share every gathered block, with a
    per-query causal mask; the loader adapts to the pool dtype.

Each blockwise version takes `splits=`: the kernel's split of a row's
pages over CTAs (flash-decoding). `split_ranges` partitions the pages
as the kernel does, each split runs the online loop over its own pages
in stages of pages_per_block, and `merge_splits` combines the partials in
split order. splits=1 is the reference's loop, unchanged.

The JAX semantics kept exactly: the masked score is the finite NEG_INF
(-1e30), so a row whose mask is all false (cache_len 0) gives the mean of
every gathered v line; the blockwise versions keep p in f32 for the value
product (decode_attention rounds it to bf16); the 1/sqrt(Hd) scale
multiplies after the q.k dot; out = acc / max(l, 1e-30), then bf16;
`quantize_pool` rounds half to even, as jnp.round does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models.attention import (NEG_INF, decode_attention,
                                          decode_attention_multi)
from repro_torch.models.layers import PARAM_DTYPE

INT8_MAX = 127.0

LoadBlock = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P,page,KvH,Hd)[(B,npt)] -> (B, npt*page, KvH, Hd), context order."""
    b, npt = block_table.shape
    _, page, kvh, hd = pool.shape
    flat = pool.index_select(0, block_table.reshape(-1).long())
    return flat.reshape(b, npt * page, kvh, hd)


def quantize_pool(pool: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """serve.kvcache.quantize_page over a whole pool: one symmetric f32
    scale per page. Returns (int8 pool, (P,) f32 scales)."""
    f = pool.float()
    amax = f.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp_min(amax, 1e-8) / INT8_MAX
    q = torch.clamp(torch.round(f / scale[:, None, None, None]),
                    -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale


def paged_decode_ref(q, kpool, vpool, block_table, cache_len
                     ) -> torch.Tensor:
    """Full-gather oracle: materialize the context and run the serving
    path's decode attention. q rank selects the math: (B,H,Hd) one token,
    (B,Q,H,Hd) multi-query verify."""
    k = gather_pages(kpool, block_table)
    v = gather_pages(vpool, block_table)
    if q.dim() == 4:
        return decode_attention_multi(q, k, v, cache_len)
    return decode_attention(q[:, None], k, v, cache_len)[:, 0]


def _float_loader(kpool, vpool) -> LoadBlock:
    def load_block(ids):
        return (gather_pages(kpool, ids).float(),
                gather_pages(vpool, ids).float())
    return load_block


def _int8_loader(kpool, vpool, kscale, vscale) -> LoadBlock:
    _, page, kvh, hd = kpool.shape

    def deq(pool, scales, ids):
        b, ppb = ids.shape
        flat = ids.reshape(-1).long()
        blk = pool.index_select(0, flat).float()          # (B*ppb,pg,kvh,hd)
        f = blk * scales.index_select(0, flat)[:, None, None, None]
        return f.reshape(b, ppb * page, kvh, hd)

    def load_block(ids):
        return deq(kpool, kscale, ids), deq(vpool, vscale, ids)
    return load_block


def _online_block_scan_multi(q, block_table, cache_len, load_block: LoadBlock,
                             *, pages_per_block: int, page: int, kvh: int,
                             splits: int = 1) -> torch.Tensor:
    """The online-softmax loop over blocks of pages_per_block pages, for
    q (B,Q,H,Hd): query j sits at absolute position cache_len - Q + j and
    its causal mask is pos <= q_pos. The single-query loop of the JAX
    package (`_online_block_scan`) is this loop at Q = 1 (its mask pos <
    cache_len is pos <= cache_len - 1), with the same arithmetic. splits >
    1 runs it over each split's pages (`_split_partials`) and merges the
    partials in split order (`merge_splits`)."""
    if splits > 1:
        m, l, acc = _split_partials(q, block_table, cache_len, load_block,
                                    pages_per_block=pages_per_block,
                                    page=page, kvh=kvh, splits=splits)
        return merge_splits(m, l, acc)
    b, qn, h, hd = q.shape
    npt = block_table.shape[1]
    n_blocks = npt // pages_per_block
    span = pages_per_block * page
    g = h // kvh
    scale = hd ** -0.5
    dev = q.device
    qr = q.reshape(b, qn, kvh, g, hd).permute(0, 2, 3, 1, 4).float()
    clen = torch.as_tensor(cache_len, device=dev)
    q_pos = clen[:, None] - qn + torch.arange(qn, device=dev)[None, :]
    m = torch.full((b, kvh, g, qn), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, qn), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, qn, hd), dtype=torch.float32, device=dev)
    for bi in range(n_blocks):
        ids = block_table[:, bi * pages_per_block:(bi + 1) * pages_per_block]
        kb, vb = load_block(ids)
        pos = bi * span + torch.arange(span, device=dev)
        valid = pos[None, None, :] <= q_pos[:, :, None]          # (B,Q,span)
        s = torch.einsum("bkgqd,bskd->bkgqs", qr, kb) * scale
        s = torch.where(valid[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        e = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + e.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", e, vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, qn, h, hd)
    return out.to(PARAM_DTYPE)


def split_ranges(cache_len, npt: int, page: int, qn: int, splits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), each (splits, B): split s of row b walks pages [lo, hi),
    as csrc/paged_decode.cu partitions them. A row's pages are its live
    ones (through its last query's position), or all npt where some query
    sees nothing (cache_len < Q: that query averages every gathered
    line); split s takes [s n / splits, (s+1) n / splits) of those n, so
    the ranges tile them in order and a split may be empty."""
    clen = torch.as_tensor(cache_len).long()
    live = torch.clamp(torch.div(clen - 1, page, rounding_mode="floor") + 1,
                       max=npt)
    n = torch.where(clen - qn >= 0, live, torch.full_like(clen, npt))
    s = torch.arange(splits, device=clen.device)[:, None]
    return s * n[None] // splits, (s + 1) * n[None] // splits


def _split_partials(q, block_table, cache_len, load_block: LoadBlock, *,
                    pages_per_block: int, page: int, kvh: int, splits: int):
    """Each split's (m, l, acc): m, l (S, B, KvH, G, Q), acc (S, B, KvH, G,
    Q, Hd), f32. A split walks its pages in stages of pages_per_block (the
    last may be shorter) with the online loop; lines outside the split
    score -inf (they drop out), masked lines inside it -1e30, as in the
    one-split loop. A split with no page keeps m = -1e30, l = 0, acc = 0."""
    b, qn, h, hd = q.shape
    npt = block_table.shape[1]
    g = h // kvh
    scale = hd ** -0.5
    dev = q.device
    qr = q.reshape(b, qn, kvh, g, hd).permute(0, 2, 3, 1, 4).float()
    clen = torch.as_tensor(cache_len, device=dev)
    q_pos = clen[:, None] - qn + torch.arange(qn, device=dev)[None, :]
    lo, hi = (x.to(dev) for x in split_ranges(clen, npt, page, qn, splits))
    ppb = pages_per_block
    line = torch.arange(ppb * page, device=dev)
    parts = []
    for si in range(splits):
        m = torch.full((b, kvh, g, qn), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, qn), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, qn, hd), dtype=torch.float32,
                          device=dev)
        n_stages = int(((hi[si] - lo[si] + ppb - 1) // ppb).max())
        for st in range(n_stages):
            pg = lo[si][:, None] + st * ppb + torch.arange(ppb, device=dev)
            ids = block_table.gather(1, torch.clamp(pg, max=npt - 1))
            kb, vb = load_block(ids)
            pos = pg[:, line // page] * page + line % page     # (B, span)
            inside = pg[:, line // page] < hi[si][:, None]
            valid = pos[:, None, :] <= q_pos[:, :, None]      # (B,Q,span)
            s = torch.einsum("bkgqd,bskd->bkgqs", qr, kb) * scale
            s = torch.where(valid[:, None, None], s, NEG_INF)
            s = torch.where(inside[:, None, None, None], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            e = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + e.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                       e, vb)
            m = m_new
        parts.append((m, l, acc))
    return tuple(torch.stack(x) for x in zip(*parts))


def merge_splits(m, l, acc) -> torch.Tensor:
    """Combine per-split partials (as `_split_partials` returns them) in
    split order 0..S-1: M = max m_s, w_s = exp(m_s - M), out = sum acc_s
    w_s / max(sum l_s w_s, 1e-30), rounded once to bf16 as (B, Q, H, Hd).
    Splits with no page (m = -1e30, l = 0, acc = 0) add nothing; in a row
    that sees nothing every m_s is -1e30, so every w_s is 1 and out is the
    mean of every line."""
    big = m.amax(dim=0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for si in range(m.shape[0]):
        w = torch.exp(m[si] - big)
        num = num + acc[si] * w[..., None]
        den = den + l[si] * w
    out = num / torch.clamp_min(den[..., None], 1e-30)
    b, kvh, g, qn, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, qn, kvh * g, hd).to(
        PARAM_DTYPE)


def _scan(q, block_table, cache_len, load_block, pages_per_block, kpool,
          splits=1):
    """The block loop for either q rank (rank 3 is Q = 1)."""
    _, page, kvh, _ = kpool.shape
    q4 = q[:, None] if q.dim() == 3 else q
    out = _online_block_scan_multi(q4, block_table, cache_len, load_block,
                                   pages_per_block=pages_per_block,
                                   page=page, kvh=kvh, splits=splits)
    return out[:, 0] if q.dim() == 3 else out


def paged_decode_gather(q, kpool, vpool, block_table, cache_len, *,
                        pages_per_block: int, splits: int = 1
                        ) -> torch.Tensor:
    """Blockwise gather + online softmax over a full-precision pool;
    q (B,H,Hd)."""
    return _scan(q, block_table, cache_len, _float_loader(kpool, vpool),
                 pages_per_block, kpool, splits)


def paged_decode_verify(q, kpool, vpool, block_table, cache_len, *,
                        pages_per_block: int, kscale=None,
                        vscale=None, splits: int = 1) -> torch.Tensor:
    """The multi-query route: q (B,Q,H,Hd) (rank 3 is Q = 1) against the
    pool; float pools load as they are, int8 pools dequantize per page
    with kscale/vscale."""
    if kpool.dtype.is_floating_point:
        load_block = _float_loader(kpool, vpool)
    else:
        if kscale is None or vscale is None:
            raise ValueError("paged_decode verify needs kscale/vscale for "
                             "an int8 pool")
        load_block = _int8_loader(kpool, vpool, kscale, vscale)
    return _scan(q, block_table, cache_len, load_block, pages_per_block,
                 kpool, splits)


def paged_decode_int8(q, kpool, vpool, block_table, cache_len, kscale,
                      vscale, *, pages_per_block: int, splits: int = 1
                      ) -> torch.Tensor:
    """Blockwise gather over an int8 pool with per-page dequantization
    inside the loop; q (B,H,Hd)."""
    return _scan(q, block_table, cache_len,
                 _int8_loader(kpool, vpool, kscale, vscale),
                 pages_per_block, kpool, splits)
