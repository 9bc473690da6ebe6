"""The port's paged decode family against the JAX package's on the same
numpy inputs: the plain versions (ref, gather, int8, verify) through both
registries (`dispatch("paged_decode", ...)`, the port on the CPU) for
every pages_per_block of the menu, q of rank 3 and 4, bf16 and int8 pools,
a non-dividing pages_per_block (clamped, never dropping pages), rows with
cache_len 0 and below Q; `quantize_pool` and `decode_attention_multi`;
the registry's versions, default, tunables, routes and refusals; the
problem key, the clamp, the example inputs and the Hopper config space.

Tolerance: within OUT_ULPS = 1 bf16 ulp of each value (of max(|value|, 1%
of the largest)): both packages run the same f32 arithmetic and round
once to bf16, only einsum's summation order may differ (at these shapes
the outputs have come out bit-equal). quantize_pool is bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.paged import kernel_def as jkdef
from repro.kernels.paged import paged as jpaged
from repro.models import attention as jattn
from repro_torch.core import gpu_model
from repro_torch.kernels import api
from repro_torch.kernels.paged import kernel_def, paged, paged_cuda
from repro_torch.kernels.paged.kernel_def import (PPB_MENU, PagedBlockConfig,
                                                  PagedKey)
from repro_torch.models import attention

OUT_ULPS = 1.0
B, H, KVH, HD, PAGE, NPT, POOL = 3, 6, 2, 32, 4, 8, 30


def _ulps(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum(np.abs(want), np.abs(want).max() * 1e-2)
    return float((np.abs(got - want) / scale).max()) * 2 ** 7


def _inputs(qlen, cache_len=(0, 13, 32), seed=0):
    """numpy f32 q (rank 3 at qlen 0), pools, a permuted table, cache_len."""
    rng = np.random.default_rng(seed)
    qshape = (B, H, HD) if qlen == 0 else (B, qlen, H, HD)
    q = rng.standard_normal(qshape).astype(np.float32)
    kp = rng.standard_normal((POOL, PAGE, KVH, HD)).astype(np.float32)
    vp = rng.standard_normal((POOL, PAGE, KVH, HD)).astype(np.float32)
    tbl = rng.permutation(POOL)[:B * NPT].reshape(B, NPT).astype(np.int32)
    return q, kp, vp, tbl, np.asarray(cache_len, np.int32)


def _both(q, kp, vp, tbl, cl, int8=False):
    """(jax args, jax kwargs, torch args, torch kwargs): bf16 q and pools
    (int8 pools with scales from each package's quantize_pool)."""
    jargs = [jnp.asarray(q).astype(jnp.bfloat16),
             jnp.asarray(kp).astype(jnp.bfloat16),
             jnp.asarray(vp).astype(jnp.bfloat16), jnp.asarray(tbl),
             jnp.asarray(cl)]
    targs = [torch.from_numpy(q).to(torch.bfloat16),
             torch.from_numpy(kp).to(torch.bfloat16),
             torch.from_numpy(vp).to(torch.bfloat16), torch.from_numpy(tbl),
             torch.from_numpy(cl)]
    jkw, tkw = {}, {}
    if int8:
        (jargs[1], jks), (jargs[2], jvs) = (jpaged.quantize_pool(jargs[1]),
                                            jpaged.quantize_pool(jargs[2]))
        (targs[1], tks), (targs[2], tvs) = (paged.quantize_pool(targs[1]),
                                            paged.quantize_pool(targs[2]))
        jkw, tkw = dict(kscale=jks, vscale=jvs), dict(kscale=tks, vscale=tvs)
    return jargs, jkw, targs, tkw


def _run(version, ppb, jargs, jkw, targs, tkw):
    jcfg = None if ppb is None else jkdef.PagedBlockConfig("t", ppb)
    tcfg = None if ppb is None else PagedBlockConfig("t", ppb)
    want = japi.dispatch("paged_decode", *jargs, version=version,
                         config=jcfg, **jkw)
    got = api.dispatch("paged_decode", *targs, version=version, config=tcfg,
                       device="cpu", **tkw)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("qlen", [0, 4])
@pytest.mark.parametrize("version,int8", [("gather", False),
                                          ("int8", False), ("int8", True),
                                          ("verify", False),
                                          ("verify", True)])
def test_versions_match_jax_every_block(qlen, version, int8):
    """Every menu block that tiles npt, and 3 (clamped to 2)."""
    q, kp, vp, tbl, cl = _inputs(qlen, seed=qlen)
    jargs, jkw, targs, tkw = _both(q, kp, vp, tbl, cl, int8)
    for ppb in [p for p in PPB_MENU if NPT % p == 0 and p <= NPT] + [3]:
        got, want = _run(version, ppb, jargs, jkw, targs, tkw)
        assert np.isfinite(got).all()
        assert _ulps(got, want) <= OUT_ULPS, (version, int8, ppb)


@pytest.mark.parametrize("qlen", [0, 4])
def test_ref_matches_jax_and_blockwise_stays_near_ref(qlen):
    q, kp, vp, tbl, cl = _inputs(qlen, cache_len=(1, 13, 32), seed=5)
    jargs, jkw, targs, tkw = _both(q, kp, vp, tbl, cl)
    got, want = _run("ref", None, jargs, jkw, targs, tkw)
    assert _ulps(got, want) <= OUT_ULPS
    # the blockwise versions keep p in f32 where ref rounds it to bf16:
    # within 8e-3, as tests/test_kvcache.py holds the JAX pair
    blk, _ = _run("gather", 2, jargs, jkw, targs, tkw)
    assert np.abs(blk - got).max() <= 8e-3


def test_row_that_sees_nothing_is_the_mean_of_its_lines():
    q, kp, vp, tbl, cl = _inputs(0, cache_len=(0, 13, 32), seed=6)
    _, _, targs, _ = _both(q, kp, vp, tbl, cl)
    out = api.dispatch("paged_decode", *targs, version="gather",
                       config=PagedBlockConfig("t", 4), device="cpu")
    lines = paged.gather_pages(targs[2], targs[3][:1]).float()[0]
    mean = lines.mean(0)                                    # (KvH, Hd)
    row0 = out[0].float().reshape(KVH, H // KVH, HD)
    assert float((row0 - mean[:, None]).abs().max()) <= 1e-2


def test_quantize_pool_bit_equal():
    _, kp, _, _, _ = _inputs(0, seed=7)
    kp[3] = 0.0                                          # an all-zero page
    kp[4, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    kp[4, 1:] = 0.0
    kp[4, 0, 1:] = 0.0
    kp[4, 0, 0, 4:] = 0.0
    jq, js = jpaged.quantize_pool(jnp.asarray(kp).astype(jnp.bfloat16))
    tq, ts = paged.quantize_pool(torch.from_numpy(kp).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[4, 0, 0, :4].tolist() == [127, 0, 2, -2]


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_multi_matches_jax(window):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 3, H, HD)).astype(np.float32)
    k = rng.standard_normal((2, 20, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((2, 20, KVH, HD)).astype(np.float32)
    for clen in (np.array([17, 3], np.int32), 11):
        want = jattn.decode_attention_multi(
            *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(clen), window=window)
        got = attention.decode_attention_multi(
            *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
            torch.as_tensor(clen), window=window)
        assert _ulps(got.float().numpy(), want) <= OUT_ULPS


def test_registry_versions_default_and_tunables():
    k = api.get_kernel("paged_decode")
    jk = japi.get_kernel("paged_decode")
    assert k.versions == jk.versions == ("ref", "gather", "int8", "verify")
    assert k.default_version == jk.default_version == "gather"
    assert set(k.tunable) == set(jk.tunable) == {"gather", "int8", "verify"}
    assert "paged_decode" in api.list_kernels()
    assert kernel_def.PPB_MENU == jkdef.PPB_MENU


def test_problem_key_clamp_and_example_match_jax():
    for qlen in (0, 4):
        q, kp, vp, tbl, cl = _inputs(qlen)
        jargs, _, targs, _ = _both(q, kp, vp, tbl, cl)
        jkey = japi.get_kernel("paged_decode").problem_key(*jargs)
        tkey = api.get_kernel("paged_decode").problem_key(*targs)
        assert tkey.key_dims() == jkey.key_dims()
        assert len(tkey.key_dims().split("x")) == (6 if qlen == 0 else 7)
    for ppb, npt in ((3, 8), (16, 8), (5, 10), (7, 7), (8, 12)):
        key = PagedKey(b=1, h=2, kvh=1, page=4, npt=npt, hd=16)
        assert PagedBlockConfig("t", ppb).clamped(key).pages_per_block \
            == jkdef.PagedBlockConfig("t", ppb).clamped(
                jkdef.PagedKey(b=1, h=2, kvh=1, page=4, npt=npt, hd=16)
            ).pages_per_block
    for qlen in (1, 4):
        tkey = PagedKey(b=3, h=4, kvh=2, page=4, npt=5, hd=16, qlen=qlen)
        jkey = jkdef.PagedKey(b=3, h=4, kvh=2, page=4, npt=5, hd=16,
                              qlen=qlen)
        (tq, tkp, _, ttbl, tcl), _ = api.get_kernel(
            "paged_decode").make_example(tkey)
        (jq, jkp, _, jtbl, jcl), _ = japi.get_kernel(
            "paged_decode").make_example(jkey)
        assert tuple(tq.shape) == jq.shape and tuple(tkp.shape) == jkp.shape
        np.testing.assert_array_equal(ttbl.numpy(), np.asarray(jtbl))
        np.testing.assert_array_equal(tcl.numpy(), np.asarray(jcl))


def test_config_space_is_the_blocks_that_fit_one_cta():
    k = api.get_kernel("paged_decode")
    key = PagedKey(b=4, h=12, kvh=2, page=16, npt=64, hd=128, qlen=4)
    assert [c.pages_per_block for c in k.config_space(key, "verify")] \
        == list(PPB_MENU)
    assert k.config_space(key, "ref") == []
    # a wide group at large pages and a long context: the biggest blocks
    # do not fit even at one split
    wide = PagedKey(b=1, h=32, kvh=2, page=32, npt=512, hd=128, qlen=4)
    fits = [c.pages_per_block for c in k.config_space(wide, "gather")]
    for ppb in PPB_MENU:
        need = PagedBlockConfig("t", ppb).smem_bytes(wide, 2)
        assert (ppb in fits) == (need <= paged_cuda.SMEM_PER_BLOCK)
    assert fits and fits != list(PPB_MENU)
    assert len(k.config_space(wide, "int8")) >= len(fits)
    # the model ranks fewer, larger blocks first at equal bytes
    ranked = [k.model_step_s(key, c, "verify") for c in
              k.config_space(key, "verify")]
    assert ranked == sorted(ranked, reverse=True)
    # an int8 pool loads half the bytes a stage and pays the widening of
    # its lines to bf16 in the chunks
    i8, bf = (gpu_model.paged_terms(key, PagedBlockConfig("t", 16), kvb)
              for kvb in (1, 2))
    assert i8["load_s"] < bf["load_s"] and i8["compute_s"] > bf["compute_s"]


@pytest.mark.parametrize("hd", [16, 48, 80, 256])
def test_head_dims_outside_the_built_instances_have_no_configs(hd):
    """The kernel is built for Hd 32, 64 and 128 (every config's head dim
    and reduce_config's 32): another head dim offers the tuner nothing."""
    k = api.get_kernel("paged_decode")
    key = PagedKey(b=2, h=4, kvh=2, page=16, npt=8, hd=hd)
    for version in ("gather", "int8", "verify"):
        assert k.config_space(key, version) == []
    for built in paged_cuda.HEAD_DIMS:
        key = PagedKey(b=2, h=4, kvh=2, page=16, npt=8, hd=built)
        assert [c.pages_per_block for c in k.config_space(key, "gather")] \
            == [1, 2, 4, 8]


def test_missing_scales_raise_and_int8_pool_form_matches_on_the_fly():
    q, kp, vp, tbl, cl = _inputs(0, seed=9)
    _, _, targs, tkw = _both(q, kp, vp, tbl, cl, int8=True)
    _, _, fargs, _ = _both(q, kp, vp, tbl, cl)
    cfg = PagedBlockConfig("t", 4)
    for version in ("int8", "verify"):
        with pytest.raises(ValueError, match="kscale/vscale"):
            api.dispatch("paged_decode", *targs, version=version,
                         config=cfg, device="cpu")
    auto = api.dispatch("paged_decode", *fargs, version="int8", config=cfg,
                        device="cpu")
    explicit = api.dispatch("paged_decode", *targs, version="int8",
                            config=cfg, device="cpu", **tkw)
    assert torch.equal(auto, explicit)


def test_wrappers_take_the_plain_version_on_the_cpu():
    q, kp, vp, tbl, cl = _inputs(0, seed=10)
    _, _, (tq, tkp, tvp, ttbl, tcl), _ = _both(q, kp, vp, tbl, cl)
    before = [f.launches for f in paged_cuda.ENTRY_POINTS]
    got = paged_cuda.paged_decode_gather(tq, tkp, tvp, ttbl, tcl, 2)
    want = paged.paged_decode_gather(tq, tkp, tvp, ttbl, tcl,
                                     pages_per_block=2)
    assert torch.equal(got, want)
    assert [f.launches for f in paged_cuda.ENTRY_POINTS] == before
