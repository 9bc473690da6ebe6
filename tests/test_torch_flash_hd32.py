"""Head dim 32 on the flash kernels: the card has Hd 64 and 128 instances,
and `reduce_config` gives Hd 32, so the wrappers zero-pad q, k, v and dout
to Hd 64 (`run_head_dim`, `pad_head_dim`), launch with the scale of the
true head dim and slice the results back. This runs that route on the
CPU through the plain versions — pad, the Hd 64 arithmetic with scale
1/sqrt(32), slice — and holds it against the JAX package's
`flash_attention_diff` at Hd 32 (forward and backward through its Pallas
kernels in interpret mode) at reduce_config's qwen2 heads (12 q heads, 2
kv heads at d_model 384) and S = 256, a multiple of 256 as the reference's
flash path needs. The padded columns of every result are exact zeros, and
lse equals the unpadded one's.

Tolerances (those of tests/test_torch_flash_bwd.py): bf16 results within
one bf16 ulp at the largest |JAX| element of each tensor; lse within
1e-5 (f32; padding adds exact zeros to every product)."""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels.flash import flash as jflash
from repro_torch.configs.base import reduce_config
from repro_torch.kernels.flash import flash_cuda
from repro_torch.kernels.flash.flash_cuda import FlashBlockConfig

LSE_ATOL = 1e-5


def _torch(a):
    return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)


def _model(x, b):
    bh, s, hd = x.shape
    return x.reshape(b, bh // b, s, hd).permute(0, 2, 1, 3)


def _planar(x):
    b, s, h, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, hd)


def _within_ulp(got, want):
    got = np.asarray(got, np.float32)
    ulp = 2.0 ** (math.floor(math.log2(float(np.max(np.abs(want))))) - 7)
    assert float(np.max(np.abs(got - want))) <= ulp


def test_reduce_config_head_dim_runs_padded():
    cfg = reduce_config(repro_torch.get_config("qwen2-1.5b"), d_model=384)
    assert cfg.head_dim == 32 and (cfg.n_heads, cfg.n_kv_heads) == (12, 2)
    assert flash_cuda.run_head_dim(32) == 64
    assert flash_cuda.run_head_dim(64) == 64
    assert flash_cuda.run_head_dim(128) == 128
    assert flash_cuda.run_head_dim(96) == 96        # no instance: raises on a card
    x = torch.randn(2, 8, 3, 32)
    p = flash_cuda.pad_head_dim(x, 64)
    assert p.shape == (2, 8, 3, 64) and torch.equal(p[..., :32], x)
    assert not p[..., 32:].any()
    assert flash_cuda.pad_head_dim(x, 32) is x


@pytest.mark.parametrize("causal", [True, False])
def test_padded_route_matches_pallas_at_hd32(causal):
    b, h, kvh, s, hd, blk = 2, 12, 2, 256, 32, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
                   for shape in ((b * h, s, hd), (b * kvh, s, hd),
                                 (b * kvh, s, hd), (b * h, s, hd)))

    def f(q, k, v):
        return jflash.flash_attention_diff(q, k, v, blk, blk, causal, True)

    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = (_model(_torch(x), b) for x in (q, k, v, do))
    hp = flash_cuda.run_head_dim(hd)
    pq, pk, pv, pdo = (flash_cuda.pad_head_dim(x, hp) for x in (tq, tk, tv, tdo))
    cfg = FlashBlockConfig("t", blk, blk)
    scale = hd ** -0.5                      # the true head dim's, not 64's
    out_p, lse_p = flash_cuda.flash_fwd_plain(pq, pk, pv, cfg, causal, scale)
    out, lse = flash_cuda.flash_fwd_plain(tq, tk, tv, cfg, causal)
    assert not out_p[..., hd:].any()
    assert float((lse_p - lse).abs().max()) <= LSE_ATOL
    out_p = out_p[..., :hd]
    _within_ulp(_planar(out_p).float().numpy(), np.asarray(jout, np.float32))

    delta = _planar(tdo.float() * out_p.float()).sum(-1)
    dq = flash_cuda.flash_bwd_dq_plain(pq, pk, pv, pdo, lse_p, delta, cfg,
                                       causal, scale)
    dk, dv = flash_cuda.flash_bwd_dkv_plain(pq, pk, pv, pdo, lse_p, delta, cfg,
                                            causal, scale)
    for got, want in ((dq, jgrads[0]), (dk, jgrads[1]), (dv, jgrads[2])):
        assert got.shape[-1] == hp and not got[..., hd:].any()
        _within_ulp(_planar(got[..., :hd]).float().numpy(), want)
