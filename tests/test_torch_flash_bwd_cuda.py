"""The port's flash-attention backward kernels on a card: flash_bwd_dq and
flash_bwd_dkv against their plain versions across the compiled instances
(Hd 64 and 128; dq's blk_kv and dkv's blk_q 32 and 64), with GQA groups
1, 2, 3, 6 and 16 (the last through dkv's f32 partials), causal and
non-causal, blk_q != blk_kv, and a strided dout; the FlashAttention
gradient against autograd through the f32 oracle; the wrapper's refusals.
Every test here needs a CUDA card with sm_90a and skips without one; the
file imports nothing of jax, so it runs on a machine with the card and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py

Tolerances:
  * kernel vs plain version (both sum in f32 and round once to bf16; the
    kernel multiplies the f32 operands ds and p as a bf16 hi + lo split,
    ~16 bits, and sums in another order): max |difference| within one
    bf16 ulp of the largest |plain| element, 2^(floor(log2 max) - 7),
    between 2^-8 and 2^-7 of it.
  * the kernel's gradient (bf16 inputs) vs autograd through ref.reference
    in f32 on the same values: max-norm relative 2^-6. The kernel path
    rounds out to bf16 before delta = rowsum(dout * out) (2^-9 of out) and
    rounds dq/dk/dv to bf16 (2^-8 of the largest), the oracle neither."""

import math

import pytest
import torch

from repro_torch.kernels.flash import flash_cuda
from repro_torch.kernels.flash.ref import reference

GRAD_REF_RTOL = 2.0 ** -6


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    return torch.device("cuda")


def _inputs(dev, b, s, h, kvh, hd, causal, seed=0):
    """q, k, v, dout (bf16) and the forward's lse and delta."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, kvh, hd),
                                 (b, s, kvh, hd), (b, s, h, hd)))
    out, lse = flash_cuda.flash_fwd_plain(q, k, v,
                                          flash_cuda.FlashBlockConfig(), causal)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    return q, k, v, do, lse, delta.contiguous()


def ulp_at_max(want: torch.Tensor) -> float:
    """One bf16 ulp at the largest |want| element."""
    return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


def _close(got, want):
    return float((got.float() - want.float()).abs().max()) <= ulp_at_max(want)


# b, s, h, kvh, hd, dq's (blk_q, blk_kv), dkv's (blk_q, blk_kv), causal
CARD_CASES = [(1, 512, 12, 2, 128, (64, 64), (64, 64), True),   # training heads
              (2, 256, 12, 2, 128, (32, 64), (32, 64), True),
              (1, 256, 32, 32, 128, (64, 32), (64, 64), True),  # MHA
              (2, 128, 4, 2, 64, (64, 64), (64, 64), True),
              (1, 256, 6, 1, 64, (32, 32), (32, 64), True),
              (1, 256, 12, 2, 128, (64, 64), (64, 64), False),
              (1, 256, 24, 8, 128, (32, 64), (64, 64), True),   # group 3
              (1, 256, 16, 1, 128, (32, 64), (32, 64), True)]   # group 16


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,hd,dq_blocks,dkv_blocks,causal",
                         CARD_CASES)
def test_bwd_kernels_match_plain_on_card(cuda, b, s, h, kvh, hd, dq_blocks,
                                         dkv_blocks, causal):
    q, k, v, do, lse, delta = _inputs(cuda, b, s, h, kvh, hd, causal)
    dq_cfg = flash_cuda.FlashBlockConfig("t", *dq_blocks)
    cfg = flash_cuda.FlashBlockConfig("t", *dkv_blocks)
    n_dq, n_dkv = flash_cuda.flash_bwd_dq.launches, flash_cuda.flash_bwd_dkv.launches
    dq = flash_cuda.flash_bwd_dq(q, k, v, do, lse, delta, dq_cfg, causal)
    dk, dv = flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, cfg, causal)
    torch.cuda.synchronize()
    assert flash_cuda.flash_bwd_dq.launches == n_dq + 1
    assert flash_cuda.flash_bwd_dkv.launches == n_dkv + 1
    p_dq = flash_cuda.flash_bwd_dq_plain(q, k, v, do, lse, delta, dq_cfg,
                                         causal)
    p_dk, p_dv = flash_cuda.flash_bwd_dkv_plain(q, k, v, do, lse, delta, cfg,
                                                causal)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    for got, want in ((dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert torch.isfinite(got.float()).all()
        assert _close(got, want)


@pytest.mark.cuda
def test_outer_block_128(cuda):
    """dq's outer block at its largest, 128 query rows a CTA (256
    threads), beside dkv's default blocks."""
    q, k, v, do, lse, delta = _inputs(cuda, 1, 512, 12, 2, 128, True, seed=2)
    cfg_dq = flash_cuda.FlashBlockConfig("t", 128, 64)
    cfg_dkv = flash_cuda.DKV_BLOCKS
    dq = flash_cuda.flash_bwd_dq(q, k, v, do, lse, delta, cfg_dq)
    dk, dv = flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, cfg_dkv)
    assert _close(dq, flash_cuda.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                    cfg_dq))
    p_dk, p_dv = flash_cuda.flash_bwd_dkv_plain(q, k, v, do, lse, delta, cfg_dkv)
    assert _close(dk, p_dk) and _close(dv, p_dv)


@pytest.mark.cuda
def test_strided_dout_matches_contiguous(cuda):
    q, k, v, do, lse, delta = _inputs(cuda, 1, 256, 12, 2, 128, True, seed=1)
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous() and flash_cuda.rows_aligned(strided)
    cfg = flash_cuda.FlashBlockConfig("t", 64, 64)
    assert torch.equal(flash_cuda.flash_bwd_dq(q, k, v, strided, lse, delta, cfg),
                       flash_cuda.flash_bwd_dq(q, k, v, do, lse, delta, cfg))
    a = flash_cuda.flash_bwd_dkv(q, k, v, strided, lse, delta, cfg)
    b = flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", [(12, 2), (8, 8)])
def test_flash_attention_grad_against_f32_oracle(cuda, h, kvh):
    b, s, hd = 2, 512, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
               for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    do = torch.randn((b, s, h, hd), generator=g, device=cuda).to(torch.bfloat16)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counts = (flash_cuda.flash_bwd_dq.launches, flash_cuda.flash_bwd_dkv.launches)
    out = flash_cuda.flash_attention_diff(*leaves, flash_cuda.FlashBlockConfig())
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_cuda.flash_bwd_dq.launches, flash_cuda.flash_bwd_dkv.launches) \
        == (counts[0] + 1, counts[1] + 1)
    ref = [x.float().requires_grad_(True) for x in (q, k, v)]
    planar = [x.transpose(1, 2).reshape(-1, s, hd) for x in ref]
    r_out = reference(*planar).reshape(b, h, s, hd).transpose(1, 2)
    want = torch.autograd.grad(r_out, ref, do.float())
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - w).abs().max() / w.abs().max())
        assert err <= GRAD_REF_RTOL, err


@pytest.mark.cuda
def test_bwd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, do, lse, delta = _inputs(cuda, 1, 256, 4, 2, 128, True)
    cfg = flash_cuda.FlashBlockConfig("t", 64, 64)
    with pytest.raises(ValueError):          # f32 operands
        flash_cuda.flash_bwd_dq(q.float(), k.float(), v.float(), do.float(),
                                lse, delta, cfg)
    with pytest.raises(ValueError):          # dq's inner block not compiled
        flash_cuda.flash_bwd_dq(q, k, v, do, lse, delta,
                                flash_cuda.FlashBlockConfig("t", 64, 128))
    with pytest.raises(ValueError):          # dkv's inner block not compiled
        flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta,
                                 flash_cuda.FlashBlockConfig("t", 128, 64))
    with pytest.raises(ValueError):          # dkv takes 64 kv rows a CTA
        flash_cuda.flash_bwd_dkv(q, k, v, do, lse, delta,
                                 flash_cuda.FlashBlockConfig("t", 64, 32))
    with pytest.raises(ValueError):          # lse of the wrong shape
        flash_cuda.flash_bwd_dkv(q, k, v, do, lse[:, :128], delta, cfg)
    q96, k96, v96, do96, lse96, d96 = _inputs(cuda, 1, 256, 4, 2, 96, True)
    with pytest.raises(ValueError):          # head_dim not compiled
        flash_cuda.flash_bwd_dq(q96, k96, v96, do96, lse96, d96, cfg)
