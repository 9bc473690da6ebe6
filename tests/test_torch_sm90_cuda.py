"""The Hopper pieces of the redesigned flash kernels on a card: the shared
helpers of csrc/sm90.cuh alone (one wgmma product against torch.matmul,
one TMA box against a slice), flash_bwd_dkv bit-equal over two launches
(its group sum runs in a fixed order, in a cluster or through partials),
flash_fwd at blk_q 64 and 128 against its plain version, and the
wrappers refusing blocks the kernels do not take. Every test here needs a
CUDA card with sm_90a and skips without one; the file imports nothing of
jax, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sm90_cuda.py

Tolerances:
  * wgmma product vs torch.matmul in f32 (TF32 off) on the same bf16
    values: the products are exact in f32 and only the summation order
    differs, so max |difference| within 1e-5 of the largest |product|.
  * TMA box and dkv reruns: bit-equal.
  * flash_fwd vs flash_fwd_plain: out within 2 bf16 ulps of each value's
    magnitude, lse within 1e-4 (as tests/test_torch_flash_cuda.py)."""

import pytest
import torch

from repro_torch.kernels import sm90_check
from repro_torch.kernels.flash import flash_cuda

MATMUL_RTOL = 1e-5
OUT_ULPS = 2
LSE_ATOL = 1e-4


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(sm90_check.MODES))
@pytest.mark.parametrize("n", sm90_check.N_SIZES)
@pytest.mark.parametrize("k", sm90_check.K_SIZES)
def test_wgmma_product_matches_matmul(cuda, mode, n, k):
    a, b = _randn(cuda, (64, k), 0), _randn(cuda, (k, n), 1)
    want = a.float() @ b.float()
    got = sm90_check.wgmma_product(a, b, mode)
    assert float((got - want).abs().max()) <= MATMUL_RTOL * float(
        want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("strided", [False, True])
def test_tma_box_matches_slice(cuda, hd, strided):
    x = _randn(cuda, (2, 256, 3, hd), 2)
    if strided:     # the model layout read through strides (heads outer)
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    for rows, head, row0, b in ((64, 1, 64, 1), (32, 2, 224, 0)):
        got = sm90_check.tma_rows(x, rows, head, row0, b)
        assert torch.equal(got, x[b, row0:row0 + rows, head])


def _bwd_inputs(dev, b, s, h, kvh, hd, seed=0):
    q, k, v, do = (_randn(dev, shape, seed + i) for i, shape in enumerate(
        ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd), (b, s, h, hd))))
    out, lse = flash_cuda.flash_fwd_plain(q, k, v,
                                          flash_cuda.FlashBlockConfig(), True)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    return q, k, v, do, lse, delta.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,blk_q", [(12, 2, 64), (24, 8, 32), (4, 4, 64),
                                         (16, 1, 64)])
def test_dkv_bit_equal_over_two_launches(cuda, h, kvh, blk_q):
    """Groups 6, 3 and 1 sum in a cluster; 16 through f32 partials."""
    args = _bwd_inputs(cuda, 2, 256, h, kvh, 128)
    cfg = flash_cuda.FlashBlockConfig("t", blk_q, flash_cuda.DKV_BLK_KV)
    dk1, dv1 = flash_cuda.flash_bwd_dkv(*args, cfg)
    dk2, dv2 = flash_cuda.flash_bwd_dkv(*args, cfg)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    p_dk, p_dv = flash_cuda.flash_bwd_dkv_plain(*args, cfg)
    for got, want in ((dk1, p_dk), (dv1, p_dv)):
        ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().max())) - 7)
        assert float((got.float() - want.float()).abs().max()) <= float(ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("blk_q", flash_cuda.BLK_Q_INSTANCES)
@pytest.mark.parametrize("blk_kv", flash_cuda.BLK_KV_INSTANCES)
def test_fwd_each_instance_matches_plain(cuda, blk_q, blk_kv):
    q, k, v = (_randn(cuda, shape, i) for i, shape in enumerate(
        ((2, 512, 12, 128), (2, 512, 2, 128), (2, 512, 2, 128))))
    cfg = flash_cuda.FlashBlockConfig("t", blk_q, blk_kv)
    out, lse = flash_cuda.flash_fwd(q, k, v, cfg)
    p_out, p_lse = flash_cuda.flash_fwd_plain(q, k, v, cfg)
    scale = p_out.float().abs().clamp_min(float(p_out.float().abs().max()) * 1e-2)
    ulps = float(((out.float() - p_out.float()).abs() / scale).max()) * 2 ** 7
    assert ulps <= OUT_ULPS
    assert float((lse - p_lse).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
def test_wrappers_raise_on_blocks_the_kernels_do_not_take(cuda):
    q, k, v, do, lse, delta = _bwd_inputs(cuda, 1, 256, 4, 2, 128)
    for blk_q, blk_kv in ((32, 64), (64, 32), (256, 64)):
        with pytest.raises(ValueError):
            flash_cuda.flash_fwd(q, k, v,
                                 flash_cuda.FlashBlockConfig("t", blk_q, blk_kv))
    for blk_q, blk_kv in ((64, 32), (128, 64), (16, 64), (64, 128)):
        with pytest.raises(ValueError):
            flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta,
                                     flash_cuda.FlashBlockConfig("t", blk_q, blk_kv))
