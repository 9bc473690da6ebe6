"""The port's paged decode kernels on a card: the three entry points of
csrc/paged_decode.cu (gather, int8, verify) against their plain versions
at qwen2-1.5b's decode shape (B=4, H=12, KvH=2, Hd=128, page 16, 64 pages
a row) with a permuted table and ragged cache_len (one ending mid-page),
every pages_per_block of the menu, verify with Q=4 on bf16 and int8
pools, rows with cache_len 0 and below Q, gather against the ref oracle,
bit-equal reruns, the launch counters, the registry's routes, and what
the wrappers refuse. Every test here needs a CUDA card with sm_90a and
skips without one; the file imports nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_cuda.py

Tolerance: within OUT_ULPS = 2 bf16 ulps of the plain version's value
(of max(|value|, 1% of the largest)): both sum in f32 in another order
and each rounds once to bf16. Against "ref" (which rounds p to bf16
before the value product) within REF_ATOL = 8e-3, as the JAX package's
tests/test_kvcache.py holds gather to ref."""

import pytest
import torch

from repro_torch.kernels import api
from repro_torch.kernels.paged import paged, paged_cuda
from repro_torch.kernels.paged.kernel_def import PPB_MENU, PagedBlockConfig

pytestmark = pytest.mark.cuda

OUT_ULPS = 2.0
REF_ATOL = 8e-3
B, H, KVH, HD, PAGE, NPT, POOL = 4, 12, 2, 128, 16, 64, 300


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    return torch.device("cuda")


def _ulps(got, want) -> float:
    want = want.float()
    scale = want.abs().clamp_min(float(want.abs().max()) * 1e-2)
    return float(((got.float() - want).abs() / scale).max()) * 2 ** 7


def _inputs(dev, qlen=1, cache_len=(1024, 777, 513, 327), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(B, H, HD) if qlen == 1 else rnd(B, qlen, H, HD)
    kpool = rnd(POOL, PAGE, KVH, HD)
    vpool = rnd(POOL, PAGE, KVH, HD)
    perm = torch.randperm(POOL, generator=g, device=dev)[:B * NPT]
    table = perm.reshape(B, NPT).to(torch.int32).contiguous()
    clen = torch.tensor(cache_len, dtype=torch.int32, device=dev)
    return q, kpool, vpool, table, clen


@pytest.mark.parametrize("ppb", PPB_MENU)
def test_gather_matches_plain_every_block(cuda, ppb):
    q, kp, vp, tbl, cl = _inputs(cuda)
    got = paged_cuda.paged_decode_gather(q, kp, vp, tbl, cl, ppb)
    want = paged.paged_decode_gather(q, kp, vp, tbl, cl, pages_per_block=ppb)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _ulps(got, want) <= OUT_ULPS
    ref = paged.paged_decode_ref(q, kp, vp, tbl, cl)
    assert float((got.float() - ref.float()).abs().max()) <= REF_ATOL


@pytest.mark.parametrize("ppb", PPB_MENU)
def test_int8_matches_plain_every_block(cuda, ppb):
    q, kp, vp, tbl, cl = _inputs(cuda, seed=1)
    kq, ks = paged.quantize_pool(kp)
    vq, vs = paged.quantize_pool(vp)
    got = paged_cuda.paged_decode_int8(q, kq, vq, tbl, cl, ks, vs, ppb)
    want = paged.paged_decode_int8(q, kq, vq, tbl, cl, ks, vs,
                                   pages_per_block=ppb)
    assert _ulps(got, want) <= OUT_ULPS


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ppb", PPB_MENU)
def test_verify_q4_matches_plain(cuda, int8, ppb):
    q, kp, vp, tbl, cl = _inputs(cuda, qlen=4, seed=2)
    ks = vs = None
    if int8:
        kp, ks = paged.quantize_pool(kp)
        vp, vs = paged.quantize_pool(vp)
    got = paged_cuda.paged_decode_verify(q, kp, vp, tbl, cl, ppb, ks, vs)
    want = paged.paged_decode_verify(q, kp, vp, tbl, cl, pages_per_block=ppb,
                                     kscale=ks, vscale=vs)
    assert got.shape == (B, 4, H, HD)
    assert _ulps(got, want) <= OUT_ULPS


def test_rows_that_see_nothing(cuda):
    """cache_len 0 (and, for verify, below Q) gives the reference's mean of
    every gathered v line for the queries that see no position."""
    q, kp, vp, tbl, cl = _inputs(cuda, cache_len=(0, 3, 1, 1024), seed=3)
    got = paged_cuda.paged_decode_gather(q, kp, vp, tbl, cl, 8)
    want = paged.paged_decode_gather(q, kp, vp, tbl, cl, pages_per_block=8)
    assert _ulps(got, want) <= OUT_ULPS
    mean = paged.gather_pages(vp, tbl[:1]).float().mean(1)     # (1, KvH, Hd)
    row0 = got[0].float().reshape(KVH, H // KVH, HD)
    assert float((row0 - mean[0, :, None]).abs().max()) <= 1e-2
    q4 = q[:, None].expand(B, 4, H, HD).contiguous()
    got = paged_cuda.paged_decode_verify(q4, kp, vp, tbl, cl, 4)
    want = paged.paged_decode_verify(q4, kp, vp, tbl, cl, pages_per_block=4)
    assert _ulps(got, want) <= OUT_ULPS


def test_reruns_bit_equal(cuda):
    q, kp, vp, tbl, cl = _inputs(cuda, seed=4)
    q4 = _inputs(cuda, qlen=4, seed=4)[0]
    kq, ks = paged.quantize_pool(kp)
    vq, vs = paged.quantize_pool(vp)
    for fn in (lambda: paged_cuda.paged_decode_gather(q, kp, vp, tbl, cl, 8),
               lambda: paged_cuda.paged_decode_int8(q, kq, vq, tbl, cl, ks,
                                                    vs, 16),
               lambda: paged_cuda.paged_decode_verify(q4, kq, vq, tbl, cl, 2,
                                                      ks, vs)):
        a, b = fn(), fn()
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_launch_counters_and_registry_routes(cuda):
    """dispatch launches the entry point each route names; a CPU call takes
    the plain version and launches nothing."""
    q, kp, vp, tbl, cl = _inputs(cuda, seed=5)
    q4 = _inputs(cuda, qlen=4, seed=5)[0]
    fns = paged_cuda.ENTRY_POINTS

    def counts():
        return tuple(f.launches for f in fns)

    cfg = PagedBlockConfig("t", 8)
    for version, qq, want in (("gather", q, (1, 0, 0)),
                              ("int8", q, (0, 1, 0)),
                              ("verify", q4, (0, 0, 1)),
                              ("gather", q4, (0, 0, 1)),
                              ("int8", q4, (0, 0, 1)),
                              ("ref", q, (0, 0, 0))):
        before = counts()
        out = api.dispatch("paged_decode", qq, kp, vp, tbl, cl,
                           version=version, config=cfg, device=cuda)
        torch.cuda.synchronize()
        assert out.device.type == "cuda" and out.shape == qq.shape
        assert tuple(a - b for a, b in zip(counts(), before)) == want, version
    before = counts()
    out = paged_cuda.paged_decode_gather(q.cpu(), kp.cpu(), vp.cpu(),
                                         tbl.cpu(), cl.cpu(), 8)
    assert out.device.type == "cpu" and counts() == before


def test_refusals(cuda):
    q, kp, vp, tbl, cl = _inputs(cuda, seed=6)
    with pytest.raises(ValueError, match="kpool is on cpu"):
        paged_cuda.paged_decode_gather(q, kp.cpu(), vp, tbl, cl, 8)
    with pytest.raises(ValueError, match="tile"):
        paged_cuda.paged_decode_gather(q, kp, vp, tbl, cl, 3)
    with pytest.raises(ValueError, match="kscale/vscale"):
        paged_cuda.paged_decode_verify(q, kp.to(torch.int8),
                                       vp.to(torch.int8), tbl, cl, 8)
    with pytest.raises(ValueError, match="int32"):
        paged_cuda.paged_decode_gather(q, kp, vp, tbl.long(), cl, 8)


def test_shared_memory_model_matches_the_library(cuda):
    for rows, hd, span, ppb, kvb in ((6, 128, 256, 16, 2), (24, 128, 128, 8, 1),
                                     (1, 64, 16, 1, 2), (13, 32, 64, 4, 1)):
        assert paged_cuda.library_smem_bytes(rows, hd, span, ppb, kvb) \
            == paged_cuda.smem_bytes(rows, hd, span, ppb, kvb)
