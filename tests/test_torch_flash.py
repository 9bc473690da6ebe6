"""The port's flash-attention forward against the JAX package: the plain
version (flash_fwd_plain, what a CPU tensor runs) against the Pallas
kernel in interpret mode and against both one-shot oracles, over the
sweep of tests/test_flash_kernel.py (GQA groups, causal and not, f32 and
bf16, several (blk_q, blk_kv)); the registry descriptor (dispatch on the
CPU, clamping, the Hopper shared-memory bound, the empty-menu fallback of
_dispatch_flash). The CUDA kernel against its plain version on a card is
tests/test_torch_flash_cuda.py, which imports no jax so that it runs on a
machine with the card and PyTorch alone.

Tolerances:
  * plain vs Pallas (both f32 online softmax over the same kv blocks in
    the same order): f32 outputs within 1e-5; lse within 1e-5; bf16
    outputs within one bf16 ulp (at most 2^-7 of the magnitude), since both round
    a nearly equal f32 value once.
  * vs the one-shot oracles: f32 within 1e-5 (another summation order);
    bf16 as tests/test_flash_kernel.py holds the Pallas kernel (atol 0.03,
    rtol 0.05: the oracle's bf16 output rounds a differently summed f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash as jflash
from repro.kernels.flash import kernel_def as jkd
from repro.kernels.flash.ref import reference as jref
from repro_torch.core import gpu_model, hw
from repro_torch.kernels import api
from repro_torch.kernels.flash import flash_cuda, kernel_def
from repro_torch.kernels.flash.ref import reference as tref
from repro_torch.models import attention

BF16_ULP = 2.0 ** -7     # a bf16 ulp is at most 2^-7 of the magnitude


def _mk(bh, bkv, s, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, s, hd)).astype(dtype)
            for n in (bh, bkv, bkv)]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _model_layout(x):
    """Planar (BH, S, Hd) as the model layout (1, S, BH, Hd), a view."""
    return x.permute(1, 0, 2).unsqueeze(0)


def _plain(q, k, v, blk_q, blk_kv, causal=True):
    cfg = flash_cuda.FlashBlockConfig("t", blk_q, blk_kv)
    out, lse = flash_cuda.flash_fwd(*(_model_layout(_torch(x))
                                      for x in (q, k, v)), cfg, causal)
    return out[0].permute(1, 0, 2).float().numpy(), lse.numpy()


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == ml_dtypes.bfloat16:
        scale = np.maximum(np.abs(want), np.abs(want).max() * 1e-2)
        assert np.all(np.abs(got - want) <= BF16_ULP * scale), \
            float(np.max(np.abs(got - want) / scale))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


SWEEP = [(4, 2, 128, 32),     # GQA group 2
         (2, 2, 64, 64),      # MHA
         (8, 2, 128, 16)]     # group 4


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float32])
@pytest.mark.parametrize("bh,bkv,s,hd", SWEEP)
def test_plain_matches_pallas_sweep(bh, bkv, s, hd, dtype):
    q, k, v = _mk(bh, bkv, s, hd, dtype)
    out, lse = _plain(q, k, v, 32, 32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want, jlse = jflash._fwd_with_stats(jq, jk, jv, 32, 32, True, True)
    _close(out, want, dtype)
    np.testing.assert_allclose(lse, np.asarray(jlse)[..., 0], rtol=1e-5,
                               atol=1e-5)
    _close(out, jflash.flash_attention_bhsd(jq, jk, jv, blk_q=32, blk_kv=32,
                                            interpret=True), dtype)
    oracle = np.asarray(jref(jq, jk, jv), np.float32)
    if dtype == np.float32:
        np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(out, oracle, atol=0.03, rtol=0.05)
    _close(tref(*(_torch(x) for x in (q, k, v))).float().numpy(), oracle,
           dtype)


@pytest.mark.parametrize("blk_q,blk_kv", [(32, 32), (64, 32), (32, 64),
                                          (128, 128)])
def test_plain_block_shape_sweep(blk_q, blk_kv):
    q, k, v = _mk(4, 2, 128, 32, ml_dtypes.bfloat16, seed=1)
    out, _ = _plain(q, k, v, blk_q, blk_kv)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _close(out, jflash.flash_attention_bhsd(jq, jk, jv, blk_q=blk_q,
                                            blk_kv=blk_kv, interpret=True),
           ml_dtypes.bfloat16)
    np.testing.assert_allclose(out, np.asarray(jref(jq, jk, jv), np.float32),
                               atol=0.03, rtol=0.05)


def test_plain_non_causal():
    q, k, v = _mk(2, 2, 64, 32, np.float32, seed=2)
    out, lse = _plain(q, k, v, 32, 32, causal=False)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want, jlse = jflash._fwd_with_stats(jq, jk, jv, 32, 32, False, True)
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse, np.asarray(jlse)[..., 0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        out, np.asarray(jref(jq, jk, jv, causal=False)), rtol=1e-5, atol=1e-5)


def test_plain_rejects_untiled_blocks():
    q, k, v = _mk(2, 2, 64, 32, np.float32)
    with pytest.raises(AssertionError):
        _plain(q, k, v, 48, 32)


# ---------------------------------------------------------------------------
# the registry descriptor
# ---------------------------------------------------------------------------

def _bshd(seed, b=2, s=64, h=4, kvh=2, hd=32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(torch.bfloat16)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


def test_registered_versions():
    k = api.get_kernel("flash")
    assert k.versions == ("ref", "cuda")
    assert k.default_version == "cuda" and k.tunable == ("cuda",)
    assert api.list_kernels() == ["flash", "gpp", "ssm"]


@pytest.mark.parametrize("version", ["ref", "cuda"])
def test_dispatch_on_cpu_matches_jax_registry_ref(version):
    q, k, v = _bshd(3)
    got = api.dispatch("flash", q, k, v, version=version, device="cpu")
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    want = np.asarray(jkd.KERNEL.run(jq, jk, jv, version="ref", config=None,
                                     interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.03,
                               rtol=0.05)


def test_clamp_matches_jax():
    for sq, skv, bq, bkv in [(256, 256, 64, 64), (100, 100, 64, 64),
                             (48, 96, 32, 128), (1500, 1500, 256, 256),
                             (8, 8, 64, 32)]:
        jkey = jkd.FlashKey(b=1, h=2, kvh=1, sq=sq, skv=skv, hd=32)
        tkey = kernel_def.FlashKey(b=1, h=2, kvh=1, sq=sq, skv=skv, hd=32)
        j = jkd.FlashBlockConfig("x", bq, bkv).clamped(jkey)
        t = flash_cuda.FlashBlockConfig("x", bq, bkv).clamped(tkey)
        assert (j.blk_q, j.blk_kv) == (t.blk_q, t.blk_kv)
        assert kernel_def._div_clamp(bq, sq) == jkd._div_clamp(bq, sq)
        assert kernel_def._visited_pairs(tkey, t) == jkd._visited_pairs(jkey, j)
    assert jkd.KERNEL.key_from_dims(tkey.key_dims()) == jkey


@pytest.mark.parametrize("hd", [32, 64, 128, 256, 1024])
def test_config_space_fits_hopper_shared_memory(hd):
    k = api.get_kernel("flash")
    key = kernel_def.FlashKey(b=1, h=12, kvh=2, sq=512, skv=512, hd=hd)
    space = k.config_space(key, "cuda")
    limit = hw.DEFAULT_SPEC.smem_per_block
    assert all(c.smem_bytes(hd) <= limit for c in space)
    full = [(bq, bkv) for bq in kernel_def.BLK_Q_MENU
            for bkv in kernel_def.BLK_KV_MENU
            if flash_cuda.FlashBlockConfig("t", bq, bkv).smem_bytes(hd) <= limit]
    assert [(c.blk_q, c.blk_kv) for c in space] == full
    assert (hd == 1024) == (len(full) < 12)
    for c in space:
        assert gpu_model.flash_step_s(key, c) > 0


def test_static_config_is_clamped_hopper_default():
    k = api.get_kernel("flash")
    key = kernel_def.FlashKey(b=1, h=12, kvh=2, sq=256, skv=256, hd=128)
    assert k.static_config(key, "cuda") == flash_cuda.FlashBlockConfig()
    small = dataclasses.replace(key, sq=48, skv=48)
    assert k.static_config(small, "cuda").blk_q == 48


@pytest.mark.parametrize("s", [8, 100])
def test_dispatch_flash_falls_back_when_menu_is_empty(s):
    """No menu block tiles S=8 or S=100: _dispatch_flash falls back to
    dispatch's clamped static config (64x64 clamped to 8x8 / 50x50)."""
    q, k, v = _bshd(4, b=1, s=s)
    key = api.get_kernel("flash").problem_key(q, k, v)
    assert api.get_kernel("flash").config_space(key, "cuda") == []
    cfg = api.resolve_config("flash", q, k, v, device="cpu")
    assert (cfg.blk_q, cfg.blk_kv) == (flash_cuda.div_clamp(64, s),) * 2
    got = attention._dispatch_flash(q, k, v, True)
    want = api.dispatch("flash", q, k, v, version="ref", device="cpu")
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=0.03, rtol=0.05)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _bshd(5)
    before = flash_cuda.flash_fwd.launches
    cfg = flash_cuda.FlashBlockConfig("t", 32, 32)
    out, lse = flash_cuda.flash_fwd(q, k, v, cfg)
    p_out, p_lse = flash_cuda.flash_fwd_plain(q, k, v, cfg)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    assert flash_cuda.flash_fwd.launches == before
    assert lse.shape == (2 * 4, 64) and lse.dtype == torch.float32


def test_bound_counts():
    # S=4096 causal at qwen2-1.5b's attention shape: 51.5 GFLOP of useful
    # work; S=512 moves ~3.7 MB
    assert abs(flash_cuda.useful_flops(1, 12, 4096, 4096, 128, True)
               - 51.55e9) < 0.01e9
    assert abs(flash_cuda.min_bytes(1, 12, 2, 512, 512, 128) - 3.70e6) < 0.01e6
    assert flash_cuda.useful_flops(1, 2, 64, 64, 32, False) == 4 * 2 * 64 * 64 * 32
