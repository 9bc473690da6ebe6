"""The plain version of the paged decode kernel's split (flash-decoding)
against the JAX package's paged decode on the same numpy inputs:
`paged.paged_decode_gather`, `_int8` and `_verify` with `splits=` against
`repro.kernels.paged.paged.paged_decode_gather`, `_int8` and `_verify`,
at splits 1, 2, 3, 7 and 16, every pages_per_block of the menu, Q = 1 and
4, bf16 and int8 pools, ragged cache_len, rows with fewer live pages than
splits and rows that see nothing (cache_len < Q); the partition
(`split_ranges`), an empty split's partial and the merge's two edge
cases; the wrapper's split count and shared-memory plan. CPU only.

Tolerance: within OUT_ULPS = 1 bf16 ulp of each value (of max(|value|,
1% of the largest)): both sum in f32 and round once to bf16; a split
changes only where the f32 sums round, which can move a value across one
bf16 rounding boundary."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged import paged as jpaged
from repro_torch.kernels.paged import paged, paged_cuda
from repro_torch.kernels.paged.kernel_def import PPB_MENU
from repro_torch.models.attention import NEG_INF

OUT_ULPS = 1.0
B, H, KVH, HD, PAGE, NPT, POOL = 4, 6, 2, 32, 4, 16, 80
# a row that sees nothing at Q = 1 (0), one with 2 live pages (fewer than
# most split counts; below Q = 4's first query), ragged, and full
CACHE_LEN = (0, 5, 37, 64)
SPLITS = (1, 2, 3, 7, 16)


def _ulps(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want), np.abs(want).max() * 1e-2)
    return float((np.abs(got - want) / scale).max()) * 2 ** 7


@functools.lru_cache(maxsize=None)
def _inputs(qlen: int, int8: bool):
    """numpy q (rank 3 at qlen 1), pools, a permuted table and cache_len,
    as bf16/int8 torch tensors and the same values as jax arrays."""
    rng = np.random.default_rng(40 + qlen)
    qshape = (B, H, HD) if qlen == 1 else (B, qlen, H, HD)
    q = rng.standard_normal(qshape).astype(np.float32)
    kp = rng.standard_normal((POOL, PAGE, KVH, HD)).astype(np.float32)
    vp = rng.standard_normal((POOL, PAGE, KVH, HD)).astype(np.float32)
    tbl = rng.permutation(POOL)[:B * NPT].reshape(B, NPT).astype(np.int32)
    cl = np.asarray(CACHE_LEN, np.int32)
    t = [torch.from_numpy(q).to(torch.bfloat16),
         torch.from_numpy(kp).to(torch.bfloat16),
         torch.from_numpy(vp).to(torch.bfloat16), torch.from_numpy(tbl),
         torch.from_numpy(cl)]
    j = [jnp.asarray(q).astype(jnp.bfloat16),
         jnp.asarray(kp).astype(jnp.bfloat16),
         jnp.asarray(vp).astype(jnp.bfloat16), jnp.asarray(tbl),
         jnp.asarray(cl)]
    tsc = jsc = None
    if int8:
        (t[1], tks), (t[2], tvs) = (paged.quantize_pool(t[1]),
                                    paged.quantize_pool(t[2]))
        (j[1], jks), (j[2], jvs) = (jpaged.quantize_pool(j[1]),
                                    jpaged.quantize_pool(j[2]))
        tsc, jsc = (tks, tvs), (jks, jvs)
    return t, tsc, j, jsc


@functools.lru_cache(maxsize=None)
def _jax_out(version: str, qlen: int, int8: bool, ppb: int) -> np.ndarray:
    _, _, (q, kp, vp, tbl, cl), jsc = _inputs(qlen, int8)
    if version == "gather":
        out = jpaged.paged_decode_gather(q, kp, vp, tbl, cl,
                                         pages_per_block=ppb)
    elif version == "int8":
        out = jpaged.paged_decode_int8(q, kp, vp, tbl, cl, *jsc,
                                       pages_per_block=ppb)
    else:
        kw = dict(kscale=jsc[0], vscale=jsc[1]) if int8 else {}
        out = jpaged.paged_decode_verify(q, kp, vp, tbl, cl,
                                         pages_per_block=ppb, **kw)
    return np.asarray(out, np.float32)


def _torch_out(version: str, qlen: int, int8: bool, ppb: int, splits: int):
    (q, kp, vp, tbl, cl), tsc, _, _ = _inputs(qlen, int8)
    if version == "gather":
        return paged.paged_decode_gather(q, kp, vp, tbl, cl,
                                         pages_per_block=ppb, splits=splits)
    if version == "int8":
        return paged.paged_decode_int8(q, kp, vp, tbl, cl, *tsc,
                                       pages_per_block=ppb, splits=splits)
    kw = dict(kscale=tsc[0], vscale=tsc[1]) if int8 else {}
    return paged.paged_decode_verify(q, kp, vp, tbl, cl, pages_per_block=ppb,
                                     splits=splits, **kw)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("version,qlen,int8", [
    ("gather", 1, False), ("int8", 1, True), ("verify", 1, False),
    ("verify", 4, False), ("verify", 4, True)])
def test_split_matches_jax_every_block(splits, version, qlen, int8):
    """Every pages_per_block of the menu at this split count."""
    for ppb in PPB_MENU:
        got = _torch_out(version, qlen, int8, ppb, splits)
        want = _jax_out(version, qlen, int8, ppb)
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape
        got = got.float().numpy()
        assert np.isfinite(got).all()
        assert _ulps(got, want) <= OUT_ULPS, (version, qlen, int8, ppb)


@pytest.mark.parametrize("qlen", [1, 4])
@pytest.mark.parametrize("splits", SPLITS + (64,))
def test_split_ranges_tile_each_rows_pages_in_order(qlen, splits):
    """Splits tile [0, n) in order, n the live pages (all npt in a row
    where a query sees nothing); splits > n leave some empty."""
    lo, hi = paged.split_ranges(torch.tensor(CACHE_LEN), NPT, PAGE, qlen,
                                splits)
    assert lo.shape == hi.shape == (splits, B)
    for row, clen in enumerate(CACHE_LEN):
        n = NPT if clen < qlen else min(NPT, -(-clen // PAGE))
        assert int(lo[0, row]) == 0 and int(hi[-1, row]) == n
        assert torch.equal(lo[1:, row], hi[:-1, row])
        sizes = hi[:, row] - lo[:, row]
        assert int(sizes.min()) >= 0 and int(sizes.max()) <= -(-n // splits)
        assert (int((sizes == 0).sum()) > 0) == (splits > n)


def test_empty_split_partial_and_merge_edge_cases():
    """A split with no live page keeps (m, l, acc) = (-1e30, 0, 0) and adds
    nothing; a row that sees nothing is the mean of its lines at any split
    count."""
    (q, kp, vp, tbl, cl), _, _, _ = _inputs(1, False)
    q4 = q[:, None]
    m, l, acc = paged._split_partials(
        q4, tbl, cl, paged._float_loader(kp, vp), pages_per_block=2,
        page=PAGE, kvh=KVH, splits=7)
    lo, hi = paged.split_ranges(cl, NPT, PAGE, 1, 7)
    empty = (hi - lo) == 0                                   # (S, B)
    assert bool(empty[:, 1].any())                # row 1: 2 live pages
    for s, row in empty.nonzero().tolist():
        assert bool((m[s, row] == NEG_INF).all())
        assert bool((l[s, row] == 0).all()) and bool((acc[s, row] == 0).all())
    # the merge without the empty splits gives the same bits
    keep = ~empty[:, 1]
    sub = paged.merge_splits(m[keep][:, 1:2], l[keep][:, 1:2],
                             acc[keep][:, 1:2])
    assert torch.equal(sub, paged.merge_splits(m, l, acc)[1:2])
    # row 0 (cache_len 0) sees nothing: every split's m is -1e30
    assert bool((m[:, 0] == NEG_INF).all())
    mean = paged.gather_pages(vp, tbl[:1]).float().mean(1)  # (1, KvH, Hd)
    for splits in SPLITS:
        out = paged.paged_decode_gather(q, kp, vp, tbl, cl,
                                        pages_per_block=4, splits=splits)
        row0 = out[0].float().reshape(KVH, H // KVH, HD)
        assert float((row0 - mean[0, :, None]).abs().max()) <= 1e-2


def test_split_count_and_plan():
    """16 splits at qwen2-1.5b's decode (8 (row, kv head) pairs) and at B=8
    on 132 SMs, at most npt; the stage is capped by a split's pages, the
    ring holds at most 3 stages and the whole plan fits one CTA."""
    assert paged_cuda.split_count(4, 2, 6, 64, 132) == 16
    assert paged_cuda.split_count(8, 2, 6, 512, 132) == 16
    assert paged_cuda.split_count(4, 2, 24, 64, 132) == 16
    assert paged_cuda.split_count(64, 8, 6, 512, 132) == 1
    assert paged_cuda.split_count(1, 1, 6, 4, 132) == 4
    assert paged_cuda.row_tiles(6) == (1, 1)
    assert paged_cuda.row_tiles(24) == (2, 1)
    assert paged_cuda.row_tiles(64) == (2, 2)
    for rows in (6, 24):
        for kvb in (1, 2):
            for ppb in PPB_MENU:
                shape = paged_cuda.plan(rows, 128, 16, 64, ppb, 16, kvb)
                assert shape["pages_a_stage"] == min(ppb, 4)
                assert 1 <= shape["stages"] <= 3
                assert shape["smem"] <= paged_cuda.SMEM_PER_BLOCK
    # one split of 512 pages at ppb 16: a 139 KB stage, so a ring of one
    one = paged_cuda.plan(6, 128, 16, 512, 16, 1, 2)
    assert one["stages"] == 1 and one["lines"] == 256
    long_ = paged_cuda.plan(6, 128, 16, 512, 4, 16, 2)
    assert long_["stages"] == 3 and 2 * (long_["smem"] + 1024) <= 233_472
