"""The port's flash-attention backward against the JAX package: the plain
versions of the two backward kernels (flash_bwd_dq_plain,
flash_bwd_dkv_plain, what a CPU tensor runs) and the gradient of
flash_attention_diff, against jax.vjp through the JAX custom VJP
(`flash.flash_attention_diff`, whose backward runs `_bwd_dq_kernel` and
`_bwd_dkv_kernel` in interpret mode) on the same numpy inputs; the
gradient against autograd through the f32 oracle ref.reference; and the
registry's dispatch carrying a gradient. The CUDA kernels against their
plain versions on a card are tests/test_torch_flash_bwd_cuda.py.

Tolerances:
  * bf16 inputs, plain vs Pallas: both compute in f32 and differ only in
    summation order, then round once to bf16, so max |difference| within
    one bf16 ulp at the largest |JAX| element of each tensor,
    2^(floor(log2 max) - 7) (between 2^-8 and 2^-7 of it).
  * f32 inputs, vs autograd through ref.reference (exact softmax, f32):
    max-norm relative 1e-4 (another summation order in f32)."""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash as jflash
from repro_torch.kernels import api
from repro_torch.kernels.flash import flash_cuda
from repro_torch.kernels.flash.flash_cuda import FlashBlockConfig
from repro_torch.kernels.flash.ref import reference

REF_RTOL = 1e-4


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _model(x, b):
    """Planar (B*heads, S, Hd) -> the model layout (B, S, heads, Hd)."""
    bh, s, hd = x.shape
    return x.reshape(b, bh // b, s, hd).permute(0, 2, 1, 3)


def _planar(x):
    b, s, h, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, hd)


def _inputs(b, h, kvh, s, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype)
            for shape in ((b * h, s, hd), (b * kvh, s, hd), (b * kvh, s, hd),
                          (b * h, s, hd))]


def _jax_grads(q, k, v, do, blk_q, blk_kv, causal):
    def f(q, k, v):
        return jflash.flash_attention_diff(q, k, v, blk_q, blk_kv, causal,
                                           True)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]


def _within_ulp(got, want):
    got = np.asarray(got, np.float32)
    top = float(np.max(np.abs(want)))
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    err = float(np.max(np.abs(got - want)))
    assert err <= ulp, (err, ulp)


CASES = [  # b, h, kvh, s, hd, blk_q, blk_kv, causal
    (1, 4, 4, 128, 32, 32, 32, True),      # group 1 (MHA)
    (2, 4, 2, 128, 64, 64, 64, True),      # group 2
    (1, 6, 1, 256, 64, 32, 64, True),      # group 6, blk_q != blk_kv
    (1, 6, 1, 256, 32, 64, 32, True),
    (1, 4, 2, 128, 32, 32, 64, False),     # non-causal
    (2, 6, 1, 128, 64, 64, 32, False)]


@pytest.mark.parametrize("b,h,kvh,s,hd,blk_q,blk_kv,causal", CASES)
def test_plain_backward_matches_pallas(b, h, kvh, s, hd, blk_q, blk_kv, causal):
    q, k, v, do = _inputs(b, h, kvh, s, hd, ml_dtypes.bfloat16)
    jdq, jdk, jdv = _jax_grads(q, k, v, do, blk_q, blk_kv, causal)
    tq, tk, tv, tdo = (_model(_torch(x), b) for x in (q, k, v, do))
    cfg = FlashBlockConfig("t", blk_q, blk_kv)
    out, lse = flash_cuda.flash_fwd_plain(tq, tk, tv, cfg, causal)
    delta = _planar(tdo.float() * out.float()).sum(-1)
    dq = flash_cuda.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, cfg,
                                       causal)
    dk, dv = flash_cuda.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, cfg,
                                            causal)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _within_ulp(_planar(got).float().numpy(), want)
    # the wrappers take the plain versions for CPU tensors, uncounted
    n = flash_cuda.flash_bwd_dq.launches, flash_cuda.flash_bwd_dkv.launches
    assert torch.equal(flash_cuda.flash_bwd_dq(tq, tk, tv, tdo, lse, delta,
                                               cfg, causal), dq)
    assert torch.equal(flash_cuda.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta,
                                                cfg, causal)[1], dv)
    assert (flash_cuda.flash_bwd_dq.launches,
            flash_cuda.flash_bwd_dkv.launches) == n


@pytest.mark.parametrize("h,kvh", [(6, 1), (6, 2), (4, 4)])
def test_plain_dkv_group_sum_matches_pallas(h, kvh):
    """flash_bwd_dkv_plain at group 6, 3 and 1 against the JAX backward
    (its per-q-head partials summed over the group, flash.py:296-306), and
    its group sum in q-head order: dk/dv of a group equal the f32 per-head
    results of the same function run head by head (MHA, k/v repeated),
    added in q-head order and cast once."""
    b, s, hd, blk = 1, 128, 32, 32
    q, k, v, do = _inputs(b, h, kvh, s, hd, ml_dtypes.bfloat16, seed=3)
    _, jdk, jdv = _jax_grads(q, k, v, do, blk, blk, True)
    tq, tk, tv, tdo = (_model(_torch(x), b) for x in (q, k, v, do))
    cfg = FlashBlockConfig("t", blk, blk)
    out, lse = flash_cuda.flash_fwd_plain(tq, tk, tv, cfg, True)
    delta = _planar(tdo.float() * out.float()).sum(-1)
    dk, dv = flash_cuda.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, cfg)
    _within_ulp(_planar(dk).float().numpy(), jdk)
    _within_ulp(_planar(dv).float().numpy(), jdv)
    g = h // kvh
    rk, rv = (x.repeat_interleave(g, dim=2).float() for x in (tk, tv))
    per_head = flash_cuda.flash_bwd_dkv_plain(tq.float(), rk, rv, tdo.float(),
                                              lse, delta, cfg)
    for got, heads in zip((dk, dv), per_head):
        want = heads[:, :, ::g]
        for i in range(1, g):
            want = want + heads[:, :, i::g]
        assert torch.equal(got, want.to(got.dtype))


@pytest.mark.parametrize("b,h,kvh,s,hd,blk_q,blk_kv,causal",
                         [CASES[1], CASES[2], CASES[4]])
def test_flash_attention_diff_grads_match_pallas(b, h, kvh, s, hd, blk_q,
                                                 blk_kv, causal):
    """The autograd Function end to end (forward under (blk_q, blk_kv),
    backward under the default backward blocks) against jax.vjp."""
    q, k, v, do = _inputs(b, h, kvh, s, hd, ml_dtypes.bfloat16, seed=1)
    want = _jax_grads(q, k, v, do, blk_q, blk_kv, causal)
    leaves = [_model(_torch(x), b).requires_grad_(True) for x in (q, k, v)]
    out = flash_cuda.flash_attention_diff(
        *leaves, FlashBlockConfig("t", blk_q, blk_kv), causal)
    got = torch.autograd.grad(out, leaves, _model(_torch(do), b))
    for g, w in zip(got, want):
        _within_ulp(_planar(g).float().numpy(), w)


@pytest.mark.parametrize("h,kvh,causal", [(6, 2, True), (4, 4, False)])
def test_grads_match_f32_oracle(h, kvh, causal):
    q, k, v, do = _inputs(2, h, kvh, 128, 32, np.float32, seed=2)
    leaves = [_model(_torch(x), 2).requires_grad_(True) for x in (q, k, v)]
    out = flash_cuda.flash_attention_diff(*leaves, FlashBlockConfig("t", 32, 64),
                                          causal)
    got = torch.autograd.grad(out, leaves, _model(_torch(do), 2))
    ref = [_torch(x).requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(reference(*ref, causal=causal), ref,
                               _torch(do))
    assert float((_planar(out) - reference(*ref, causal=causal)
                  ).detach().abs().max()) <= 1e-5
    for g, w in zip(got, want):
        err = float((_planar(g) - w).abs().max() / w.abs().max())
        assert err <= REF_RTOL, err


def test_dispatch_carries_a_gradient():
    """dispatch("flash", ..., device="cpu") — the model's route — returns a
    differentiable output whose grads are flash_attention_diff's."""
    q, k, v, do = _inputs(1, 4, 2, 128, 32, ml_dtypes.bfloat16, seed=3)
    leaves = [_model(_torch(x), 1).requires_grad_(True) for x in (q, k, v)]
    cfg = FlashBlockConfig("t", 64, 32)
    out = api.dispatch("flash", *leaves, causal=True, config=cfg,
                       device="cpu")
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, _model(_torch(do), 1))
    direct = flash_cuda.flash_attention_diff(*leaves, cfg, True)
    want = torch.autograd.grad(direct, leaves, _model(_torch(do), 1))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref_out = api.dispatch("flash", *leaves, causal=True, version="ref",
                           device="cpu")
    assert all(g is not None for g in torch.autograd.grad(ref_out.float().sum(),
                                                          leaves))
    with torch.no_grad():
        assert api.dispatch("flash", *leaves, config=cfg,
                            device="cpu").grad_fn is None


def test_backward_bounds_and_config():
    """The bound helpers at the training shape (B 8, H 12, KvH 2, S 512,
    Hd 128, causal), and the backward's default blocks."""
    elems = 8 * 12 * 512 * 513 // 2
    assert flash_cuda.bwd_useful_flops(8, 12, 512, 512, 128, True, "dq") \
        == 6 * 128 * elems
    assert flash_cuda.bwd_useful_flops(8, 12, 512, 512, 128, True, "dkv") \
        == 8 * 128 * elems
    q_bytes, kv_bytes = 2 * 8 * 512 * 12 * 128, 2 * 8 * 512 * 2 * 128
    stats = 2 * 4 * 8 * 12 * 512
    assert flash_cuda.bwd_min_bytes(8, 12, 2, 512, 512, 128, "dq") \
        == 3 * q_bytes + 2 * kv_bytes + stats
    assert flash_cuda.bwd_min_bytes(8, 12, 2, 512, 512, 128, "dkv") \
        == 2 * q_bytes + 4 * kv_bytes + stats
    dq_cfg, dkv_cfg = flash_cuda.bwd_configs(512, 512)
    assert (dq_cfg.blk_q, dq_cfg.blk_kv) == (flash_cuda.DQ_BLOCKS.blk_q,
                                             flash_cuda.DQ_BLOCKS.blk_kv)
    assert (dkv_cfg.blk_q, dkv_cfg.blk_kv) == (flash_cuda.DKV_BLOCKS.blk_q,
                                               flash_cuda.DKV_BLOCKS.blk_kv)
    assert dq_cfg.blk_kv in flash_cuda.DQ_BLK_KV_INSTANCES
    assert dkv_cfg.blk_q in flash_cuda.DKV_BLK_Q_INSTANCES
    assert dkv_cfg.blk_kv == flash_cuda.DKV_BLK_KV
    small_dq, small_dkv = flash_cuda.bwd_configs(48, 48)     # clamped to tile
    assert (small_dq.blk_q, small_dkv.blk_kv) == (24, 48)
