"""The port's paged decode kernels on a card: the three entry points of
csrc/paged_decode.cu (gather, int8, verify) against their plain versions
at the same split count, at qwen2-1.5b's decode shape (B=4, H=12, KvH=2,
Hd=128, page 16, 64 pages a row) with a permuted table and ragged
cache_len (one ending mid-page), every pages_per_block of the menu,
verify with Q=4 on bf16 and int8 pools, rows with cache_len 0 and below
Q, splits 1 to 64 (more splits than a short row's live pages leave empty
splits), a group wider than 16 rows (two row groups), Hd 64, pages of
4, 8 and 32 lines, gather against the ref oracle, bit-equal reruns and
CUDA-graph replays, the launch counters, the registry's routes, every
instance's registers and spills, and what the wrappers refuse. Every test here needs a CUDA card
with sm_90a and skips without one; the file imports nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_cuda.py

Tolerance: within OUT_ULPS = 2 bf16 ulps of the plain version's value
(of max(|value|, 1% of the largest)): both sum in f32 in another order,
the kernel multiplies p as a bf16 hi + lo split (~16 bits), and each
rounds once to bf16. Against "ref" (which rounds p to bf16 before the
value product) within REF_ATOL = 8e-3, as the JAX package's
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
    want = paged.paged_decode_gather(q, kp, vp, tbl, cl, pages_per_block=ppb,
                                     splits=paged_cuda.splits_for(q, kp, tbl))
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
                                   pages_per_block=ppb,
                                   splits=paged_cuda.splits_for(q, kq, tbl))
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
                                     kscale=ks, vscale=vs,
                                     splits=paged_cuda.splits_for(q, kp, tbl))
    assert got.shape == (B, 4, H, HD)
    assert _ulps(got, want) <= OUT_ULPS


def test_rows_that_see_nothing(cuda):
    """cache_len 0 (and, for verify, below Q) gives the reference's mean of
    every gathered v line for the queries that see no position."""
    q, kp, vp, tbl, cl = _inputs(cuda, cache_len=(0, 3, 1, 1024), seed=3)
    splits = paged_cuda.splits_for(q, kp, tbl)
    got = paged_cuda.paged_decode_gather(q, kp, vp, tbl, cl, 8)
    want = paged.paged_decode_gather(q, kp, vp, tbl, cl, pages_per_block=8,
                                     splits=splits)
    assert _ulps(got, want) <= OUT_ULPS
    mean = paged.gather_pages(vp, tbl[:1]).float().mean(1)     # (1, KvH, Hd)
    row0 = got[0].float().reshape(KVH, H // KVH, HD)
    assert float((row0 - mean[0, :, None]).abs().max()) <= 1e-2
    q4 = q[:, None].expand(B, 4, H, HD).contiguous()
    got = paged_cuda.paged_decode_verify(q4, kp, vp, tbl, cl, 4)
    want = paged.paged_decode_verify(q4, kp, vp, tbl, cl, pages_per_block=4,
                                     splits=splits)
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
    with pytest.raises(ValueError, match="head dim 48"):
        paged_cuda.paged_decode_gather(q[..., :48].contiguous(),
                                       kp[..., :48].contiguous(),
                                       vp[..., :48].contiguous(), tbl, cl, 8)


def test_shared_memory_model_matches_the_library(cuda):
    for rows, hd, page, npt, ppb, splits, kvb in (
            (6, 128, 16, 64, 16, 16, 2), (24, 128, 16, 64, 8, 16, 1),
            (6, 128, 16, 512, 16, 1, 2), (6, 128, 16, 512, 4, 16, 1),
            (1, 64, 16, 8, 1, 2, 2), (40, 64, 4, 12, 4, 3, 1),
            (64, 256, 16, 512, 16, 16, 2)):
        shape = paged_cuda.plan(rows, hd, page, npt, ppb, splits, kvb)
        assert paged_cuda.library_smem_bytes(rows, hd, page, npt, ppb, splits,
                                             kvb) \
            == (shape["smem"], shape["stages"])
        assert paged_cuda.smem_bytes(rows, hd, page, npt, ppb, splits, kvb) \
            == shape["smem"]


def _split_case(version, dev, qlen, cache_len, seed, int8=False, h=H,
                hd=HD, npt=NPT, page=PAGE):
    """(kernel call at splits, plain call at splits) of one case."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(B, h, hd) if qlen == 1 else rnd(B, qlen, h, hd)
    kp, vp = rnd(POOL, page, KVH, hd), rnd(POOL, page, KVH, hd)
    perm = torch.randperm(POOL, generator=g, device=dev)[:B * npt]
    tbl = perm.reshape(B, npt).to(torch.int32).contiguous()
    cl = torch.tensor(cache_len, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        kp, ks = paged.quantize_pool(kp)
        vp, vs = paged.quantize_pool(vp)

    def call(ppb, splits):
        if version == "gather":
            return paged_cuda.paged_decode_gather(q, kp, vp, tbl, cl, ppb,
                                                  splits=splits)
        if version == "int8":
            return paged_cuda.paged_decode_int8(q, kp, vp, tbl, cl, ks, vs,
                                                ppb, splits=splits)
        return paged_cuda.paged_decode_verify(q, kp, vp, tbl, cl, ppb, ks, vs,
                                              splits=splits)

    def plain(ppb, splits):
        if version == "int8":
            return paged.paged_decode_int8(q, kp, vp, tbl, cl, ks, vs,
                                           pages_per_block=ppb, splits=splits)
        return paged.paged_decode_verify(q, kp, vp, tbl, cl,
                                         pages_per_block=ppb, kscale=ks,
                                         vscale=vs, splits=splits)
    return call, plain


# cache_len: ragged (one row of 2 live pages: empty splits at 16+), and
# rows that see nothing (cache_len 0; below Q = 4)
RAGGED = (1024, 777, 17, 327)
BLIND = (0, 2, 1024, 17)


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16, 64])
@pytest.mark.parametrize("version,qlen,int8,clen", [
    ("gather", 1, False, RAGGED), ("int8", 1, True, RAGGED),
    ("verify", 4, False, RAGGED), ("verify", 4, True, RAGGED),
    ("gather", 1, False, BLIND), ("verify", 4, False, BLIND),
    ("verify", 4, True, BLIND)])
def test_split_counts_match_plain(cuda, splits, version, qlen, int8, clen):
    """Every entry point at this split count against the split-aware plain
    version, at ppb 1, 4 and 16 (a split's pages in several stages, or one
    stage shorter than ppb)."""
    call, plain = _split_case(version, cuda, qlen, clen, 7, int8)
    for ppb in (1, 4, 16):
        got, want = call(ppb, splits), plain(ppb, splits)
        assert bool(torch.isfinite(got.float()).all())
        assert _ulps(got, want) <= OUT_ULPS, (ppb, splits)


@pytest.mark.parametrize("h,hd,qlen", [(12, 64, 1), (12, 64, 4),
                                       (24, 128, 4), (4, 32, 1), (4, 32, 4),
                                       (12, 32, 4)])
def test_other_instances_match_plain(cuda, h, hd, qlen):
    """Hd 64 and 32 (reduce_config's head dim; both row tiles), and 48
    query rows a kv head (G 12 x Q 4: two row groups of 32)."""
    for version, int8 in (("verify", False), ("verify", True)):
        call, plain = _split_case(version, cuda, qlen, RAGGED, 8, int8, h=h,
                                  hd=hd)
        for splits in (1, 16):
            assert _ulps(call(4, splits), plain(4, splits)) <= OUT_ULPS


@pytest.mark.parametrize("page,npt,clen", [(4, 64, (256, 201, 7, 3)),
                                           (8, 32, (256, 131, 9, 0)),
                                           (32, 32, (1024, 777, 40, 2))])
def test_other_page_sizes_match_plain(cuda, page, npt, clen):
    """Pages of 4 and 8 lines (a 16-line chunk spans pages; a stage's last
    chunk is part zeros) and of 32, every entry point's route."""
    for version, qlen, int8 in (("gather", 1, False), ("int8", 1, True),
                                ("verify", 4, True)):
        call, plain = _split_case(version, cuda, qlen, clen, 11, int8,
                                  npt=npt, page=page)
        for ppb, splits in ((1, 1), (1, 16), (4, 3), (8, 16)):
            assert _ulps(call(ppb, splits), plain(ppb, splits)) <= OUT_ULPS, \
                (version, page, ppb, splits)


def test_graph_replays_bit_equal(cuda):
    """Ten replays of a captured CUDA graph of each entry point give the
    eager call's bits: the split and combine kernels keep no state between
    calls."""
    for version, qlen, int8 in (("gather", 1, False), ("int8", 1, True),
                                ("verify", 4, True)):
        call, _ = _split_case(version, cuda, qlen, RAGGED, 9, int8)
        eager = call(4, None)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(4, None)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call(4, None)
        for _ in range(10):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


def test_every_instance_registers_and_spills(cuda):
    """Each (pool type, head dim, row tiles) instance and the combine
    kernel compile without spills (registers a thread within 255)."""
    for int8 in (False, True):
        for hd in paged_cuda.HEAD_DIMS:
            for tiles in (1, 2):
                regs, spill = paged_cuda.kernel_attrs(int8, hd, tiles)
                assert 0 < regs <= 255 and spill == 0, (int8, hd, tiles)
    regs, spill = paged_cuda.kernel_attrs(False, 128, 0)
    assert 0 < regs <= 255 and spill == 0
