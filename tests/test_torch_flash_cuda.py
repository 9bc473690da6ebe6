"""The port's flash-attention kernel on a card: flash_fwd against its
plain version (out and lse) at the serving slice's attention shape, an
MHA shape, blk_q != blk_kv, Hd = 64 and non-causal; and a strided q view
(the model layout after rope) against a contiguous copy. Every test here
needs a CUDA card with sm_90a and skips without one; the file imports
nothing of jax, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_cuda.py

Tolerance: out (bf16) within 2 bf16 ulps of each value's magnitude (an
ulp is at most 2^-7 of it; floor 1% of the largest): the kernel's P.V
multiplies a bf16 hi+lo split of p (~16 bits) and the tensor cores sum in
another order than the plain f32 einsums, and each side rounds to bf16
once. lse (f32, magnitude ~10) within 1e-4."""

import pytest
import torch

from repro_torch.kernels.flash import flash_cuda

OUT_ULPS = 2
LSE_ATOL = 1e-4


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    return torch.device("cuda")


def _qkv(dev, b, s, h, kvh, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


def _ulps(got, want):
    want = want.float()
    scale = want.abs().clamp_min(float(want.abs().max()) * 1e-2)
    return float(((got.float() - want).abs() / scale).max()) * 2 ** 7


CARD_CASES = [(1, 256, 12, 2, 128, 64, 64, True),
              (1, 512, 12, 2, 128, 128, 32, True),
              (1, 512, 32, 32, 128, 32, 128, True),
              (2, 128, 4, 2, 64, 16, 64, True),
              (1, 256, 12, 2, 128, 64, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,hd,blk_q,blk_kv,causal", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, b, s, h, kvh, hd, blk_q, blk_kv,
                                      causal):
    q, k, v = _qkv(cuda, b, s, h, kvh, hd)
    cfg = flash_cuda.FlashBlockConfig("t", blk_q, blk_kv)
    before = flash_cuda.flash_fwd.launches
    out, lse = flash_cuda.flash_fwd(q, k, v, cfg, causal)
    torch.cuda.synchronize()
    assert flash_cuda.flash_fwd.launches == before + 1
    p_out, p_lse = flash_cuda.flash_fwd_plain(q, k, v, cfg, causal)
    assert out.shape == q.shape and lse.shape == (b * h, s)
    assert _ulps(out, p_out) <= OUT_ULPS
    assert float((lse - p_lse).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
def test_strided_view_needs_no_copy(cuda):
    q, k, v = _qkv(cuda, 1, 512, 12, 2, 128, seed=1)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    cfg = flash_cuda.FlashBlockConfig()
    a, _ = flash_cuda.flash_fwd(strided, k, v, cfg)
    b, _ = flash_cuda.flash_fwd(q, k, v, cfg)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 256, 4, 2, 128)
    with pytest.raises(ValueError):          # f32 operands
        flash_cuda.flash_fwd(q.float(), k.float(), v.float(),
                             flash_cuda.FlashBlockConfig())
    q96, k96, v96 = _qkv(cuda, 1, 256, 4, 2, 96)
    with pytest.raises(ValueError):          # head_dim not compiled
        flash_cuda.flash_fwd(q96, k96, v96, flash_cuda.FlashBlockConfig())
    with pytest.raises(ValueError):          # blk_kv not compiled
        flash_cuda.flash_fwd(q, k, v, flash_cuda.FlashBlockConfig("t", 64, 16))
    with pytest.raises(AssertionError):      # blocks do not tile S
        flash_cuda.flash_fwd(q, k, v, flash_cuda.FlashBlockConfig("t", 96, 64))
