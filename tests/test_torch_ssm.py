"""The port's selective scan against the JAX package's on the same numpy
inputs: models.mamba (`ssm_scan`, `ssm_chunked`, `ssm_decode`,
`causal_conv1d`) and the kernel's plain version against
`repro.models.mamba` and `ssm_scan_pallas(..., interpret=True)` at
tests/test_ssm_kernel.py's shapes; the registry's "ssm" family (versions,
the divisor clamp, problem_key=, the config space re-derived for Hopper)
and the kernel's I/O bytes.

Tolerances: the scan forms within atol = rtol = 1e-4, as
tests/test_ssm_kernel.py holds the Pallas kernel to the oracle (f32,
other summation orders and exp implementations). The conv is bf16 out of
an f32 sum in tap order: within one bf16 ulp of each value."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm import kernel_def as jkdef
from repro.kernels.ssm.ssm_scan import kernel_hbm_bytes as jbytes
from repro.kernels.ssm.ssm_scan import ssm_scan_pallas
from repro.models import mamba as jmamba
from repro_torch.core import gpu_model
from repro_torch.kernels import api
from repro_torch.kernels.ssm import kernel_def, ops, ssm_cuda
from repro_torch.kernels.ssm.kernel_def import SsmKey
from repro_torch.kernels.ssm.ssm_cuda import SsmScanConfig
from repro_torch.models import mamba
from repro_torch.tune import tuner

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(2, 64, 8, 4, 4), (1, 128, 16, 8, 8), (3, 32, 8, 16, 8)]


def _inputs(b, t, c, n, seed=0, bf16_params=False):
    """(x, dt, bmat, cmat, a_log, d, h0) as numpy f32, the distributions of
    tests/test_ssm_kernel.py; a_log and d rounded to bf16 (kept as f32
    values) when bf16_params."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, c)) - 2)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    alog = np.repeat(np.log(np.arange(1, n + 1, dtype=np.float32))[None], c, 0)
    d = rng.standard_normal(c).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((b, c, n))).astype(np.float32)
    if bf16_params:
        alog = np.asarray(jnp.asarray(alog, jnp.bfloat16), np.float32)
        d = np.asarray(jnp.asarray(d, jnp.bfloat16), np.float32)
    return x, dt, bm, cm, alog, d, h0


def _t(args):
    return tuple(torch.from_numpy(a) for a in args)


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("b,t,c,n,blk", SHAPES)
def test_scan_forms_match_jax(b, t, c, n, blk):
    """The oracle and the chunked form against the JAX package's. The
    chunked form is held to the oracle at chunk 8, and to the JAX chunked
    form alone at chunk 16: with these inputs (dt up to ~1.5, A down to
    -16) a 16-step chunk drives the cumulative decay below the -60 clamp
    at N = 16, and both packages' chunked forms then leave the oracle by
    ~0.08 in the same way."""
    args = _inputs(b, t, c, n)
    want = jmamba.ssm_scan(*_j(args))
    _close(mamba.ssm_scan(*_t(args)), want)
    _close(mamba.ssm_chunked(*_t(args), chunk=8), want)
    for chunk in (8, 16):
        _close(mamba.ssm_chunked(*_t(args), chunk=chunk),
               jmamba.ssm_chunked(*_j(args), chunk=chunk))


@pytest.mark.parametrize("b,t,c,n,blk", SHAPES)
def test_plain_version_matches_pallas_interpret(b, t, c, n, blk):
    """The kernel's wrapper on CPU tensors (its plain version) against the
    Pallas kernel in interpret mode, with the kernel's own blocking."""
    args = _inputs(b, t, c, n, seed=1)
    want = ssm_scan_pallas(*_j(args), blk_c=blk, interpret=True)
    cfg = SsmScanConfig("check", blk)
    _close(ssm_cuda.ssm_scan(*_t(args), cfg), want)
    _close(ssm_cuda.ssm_scan_plain(*_t(args), cfg), want)


def test_bf16_params_read_as_f32():
    """The model hands a_log and d as bf16 params; the plain version reads
    them as f32, as the Pallas kernel does."""
    args = _inputs(2, 32, 8, 16, seed=2, bf16_params=True)
    t_args = list(_t(args))
    t_args[4] = t_args[4].to(torch.bfloat16)
    t_args[5] = t_args[5].to(torch.bfloat16)
    _close(ssm_cuda.ssm_scan(*t_args), jmamba.ssm_scan(*_j(args)))


@pytest.mark.parametrize("version", ["ref", "chunked", "cuda"])
def test_dispatch_every_version_on_cpu(version):
    args = _inputs(2, 40, 16, 4, seed=3)        # chunked: T=40 -> chunk 40
    got = api.dispatch("ssm", *_t(args), version=version, device="cpu")
    assert all(g.device.type == "cpu" for g in got)
    _close(got, jmamba.ssm_scan(*_j(args)))
    _close(ops.ssm_scan(*_t(args), version=version, device="cpu"),
           jmamba.ssm_scan(*_j(args)))


def test_decode_matches_jax_and_the_scan():
    b, c, n = 3, 16, 8
    args = _inputs(b, 1, c, n, seed=4)
    x, dt, bm, cm, alog, d, h0 = args
    step = (x[:, 0], dt[:, 0], bm[:, 0], cm[:, 0], alog, d, h0)
    got = mamba.ssm_decode(*_t(step))
    _close(got, jmamba.ssm_decode(*_j(step)))
    y, h = mamba.ssm_scan(*_t(args))
    _close((got[0][:, None], got[1]), (y.numpy(), h.numpy()))


@pytest.mark.parametrize("t,with_state", [(7, False), (1, True), (12, True)])
def test_causal_conv1d_matches_jax(t, with_state):
    rng = np.random.default_rng(5)
    b, c = 2, 24
    x = jnp.asarray(rng.standard_normal((b, t, c)), jnp.bfloat16)
    w = jnp.asarray(0.5 * rng.standard_normal((mamba.CONV_K, c)), jnp.bfloat16)
    st = (jnp.asarray(rng.standard_normal((b, mamba.CONV_K - 1, c)),
                      jnp.bfloat16) if with_state else None)
    want, want_st = jmamba.causal_conv1d(x, w, st)

    def t_(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    got, got_st = mamba.causal_conv1d(t_(x), t_(w),
                                      None if st is None else t_(st))
    assert got.dtype == got_st.dtype == torch.bfloat16
    assert got_st.shape == (b, mamba.CONV_K - 1, c)
    want = np.asarray(want, np.float32)
    ulp = np.abs(want) * 2.0 ** -7
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)
    np.testing.assert_array_equal(got_st.float().numpy(),
                                  np.asarray(want_st, np.float32))


def test_registered_versions_and_default():
    assert "ssm" in api.list_kernels()
    k = api.get_kernel("ssm")
    assert k.versions == ("ref", "chunked", "cuda")
    assert k.default_version == "cuda" and k.tunable == ("cuda",)
    args = _t(_inputs(1, 8, 16, 4))
    with pytest.raises(ValueError):
        api.dispatch("ssm", *args, version="pallas", device="cpu")
    with pytest.raises(TypeError):
        api.dispatch("ssm", *args, blk_c=4, device="cpu")


@pytest.mark.parametrize("c", [1, 7, 16, 130, 3200, 6400])
def test_div_clamp_matches_jax(c):
    for blk in (1, 4, 16, 128, 256):
        assert kernel_def._div_clamp(blk, c) == jkdef._div_clamp(blk, c)
        got = SsmScanConfig("x", blk).clamped(SsmKey(1, 8, c, 16)).blk_c
        assert c % got == 0 and got <= blk


def test_config_space_is_hopper_sized():
    k = api.get_kernel("ssm")
    key = SsmKey(b=1, t=1152, c=3200, n=16)
    space = k.config_space(key, "cuda")
    assert [(cfg.states, cfg.blk_c) for cfg in space] == [
        (2, 8), (2, 16), (2, 32), (4, 8), (4, 16), (4, 32), (4, 64),
        (8, 8), (8, 16), (8, 32), (8, 64), (8, 128)]
    for cfg in space:
        assert cfg.threads(16) <= ssm_cuda.MAX_THREADS
        assert cfg.smem_bytes(16) <= ssm_cuda.SMEM_PER_BLOCK
        assert 3200 % cfg.blk_c == 0 and cfg.blk_c % 8 == 0
    # N = 4 has no 8-state instance; C = 48 no 32-channel block
    small = k.config_space(SsmKey(b=2, t=100, c=48, n=4), "cuda")
    assert {(c.states, c.blk_c) for c in small} == {
        (2, 8), (2, 16), (4, 8), (4, 16)}
    assert k.static_config(key, "cuda") == SsmScanConfig()
    assert k.static_config(SsmKey(1, 8, 24, 4), "cuda") == SsmScanConfig(
        blk_c=8, states=2)
    assert k.static_config(SsmKey(1, 8, 12, 4), "cuda").blk_c == 6
    ranked = tuner.rank_kernel("ssm", key, device="cpu")
    assert len(ranked) == len(space)
    assert all(s > 0 and np.isfinite(s) for _, s in ranked)


def test_old_cache_entry_loads(tmp_path, monkeypatch):
    """A tune-cache entry written before `states` existed ({"name",
    "blk_c"}) loads with the default states, through config_from_json and
    through the tuner's cache."""
    k = api.get_kernel("ssm")
    assert k.config_from_json({"name": "cuda", "blk_c": 16}) == SsmScanConfig(
        "cuda", 16, SsmScanConfig().states)
    monkeypatch.setenv(tuner.CACHE_ENV, str(tmp_path))
    tuner.clear_memo()
    key = SsmKey(b=1, t=64, c=32, n=16)
    ckey = tuner.cache_key_for("ssm", key, "cpu", "cuda")
    (tmp_path / tuner.CACHE_FILE).write_text(json.dumps({ckey: {
        "kernel": "ssm", "config": {"name": "cuda", "blk_c": 16},
        "modeled_s": 1e-5, "measured_s": None, "key": ckey,
        "source": "model"}}))
    tc = tuner.tune_kernel("ssm", key, device="cpu")
    assert tc.source == "cache" and tc.config == SsmScanConfig("cuda", 16)
    args = _inputs(1, 64, 32, 16, seed=7)
    _close(ops.ssm_scan(*_t(args), device="cpu"), jmamba.ssm_scan(*_j(args)))


@pytest.mark.parametrize("b,t,c,n", [(1, 1152, 3200, 16), (1, 4096, 3200, 16),
                                     (4, 256, 3200, 16), (2, 100, 48, 8)])
def test_ranking_model_order(b, t, c, n):
    """The census model ranks every config finite and positive, at least the
    bytes' time; at hymba's prefill two states a thread over small CTAs
    first (two warps on the busiest scheduler fill each other's stalls,
    which a lone warp of four states cannot), and a longer T never
    faster."""
    key = SsmKey(b=b, t=t, c=c, n=n)
    ranked = tuner.rank_kernel("ssm", key, device="cpu")
    floor = ssm_cuda.kernel_hbm_bytes(b, t, c, n) / 3.35e12
    assert ranked and all(np.isfinite(s) and s >= floor for _, s in ranked)
    assert [s for _, s in ranked] == sorted(s for _, s in ranked)
    longer = dataclasses.replace(key, t=2 * t)
    for cfg, s in ranked:
        assert gpu_model.ssm_step_s(longer, cfg) >= s
    if (b, t, c, n) == (1, 1152, 3200, 16):
        assert (ranked[0][0].states, ranked[0][0].blk_c) == (2, 8)
        assert ranked[-1][0].blk_c == 128


def test_plain_version_in_float64():
    """ssm_scan_plain(dtype=float64): the same recurrence in float64 on the
    same inputs, which phase 7c measures the f32 results against."""
    args = _t(_inputs(2, 40, 16, 8, seed=8, bf16_params=True))
    y64, h64 = ssm_cuda.ssm_scan_plain(*args, dtype=torch.float64)
    assert y64.dtype == h64.dtype == torch.float64
    y, h = ssm_cuda.ssm_scan_plain(*args)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.double().numpy(), y64.numpy(), rtol=0,
                               atol=1e-5 * float(y64.abs().max()))
    np.testing.assert_allclose(h.double().numpy(), h64.numpy(), rtol=0,
                               atol=1e-5 * float(h64.abs().max()))


def test_problem_key_override(tmp_path, monkeypatch):
    """problem_key= keys and tunes for the given problem instead of the
    one the arguments imply (test_ssm_kernel.py's shard-local case)."""
    monkeypatch.setenv(tuner.CACHE_ENV, str(tmp_path))
    tuner.clear_memo()
    args = _inputs(1, 8, 16, 4, seed=6)
    local = SsmKey(b=1, t=8, c=8, n=4)
    got = ops.ssm_scan(*_t(args), problem_key=local, device="cpu")
    _close(got, jmamba.ssm_scan(*_j(args)))
    keys = {mk[1] for mk in tuner._MEMO}
    assert tuner.cache_key_for("ssm", local, "cpu", "cuda") in keys
    full = SsmKey(b=1, t=8, c=16, n=4)
    assert tuner.cache_key_for("ssm", full, "cpu", "cuda") not in keys
    tc = tuner.tune_kernel("ssm", local, device="cpu")
    assert local.c % tc.config.blk_c == 0


def test_shape_checks():
    args = list(_t(_inputs(1, 8, 16, 4)))
    bad = list(args)
    bad[2] = bad[2][:, :, :3]
    with pytest.raises(ValueError):
        ssm_cuda.ssm_scan(*bad)
    bad = list(args)
    bad[6] = bad[6][:1, :8]
    with pytest.raises(ValueError):
        ssm_cuda.ssm_scan(*bad)


def test_kernel_bytes_match_jax():
    for dims in [(1, 1152, 3200, 16), (4, 256, 3200, 16), (2, 100, 48, 8)]:
        assert ssm_cuda.kernel_hbm_bytes(*dims) == jbytes(*dims)
    # hymba-1.5b's prefill: 45.0 MB, 13.4 us at 3.35 TB/s
    assert abs(ssm_cuda.kernel_hbm_bytes(1, 1152, 3200, 16) / 1e6 - 45.0) < 0.1


def test_make_example_runs():
    k = api.get_kernel("ssm")
    key = SsmKey(b=2, t=16, c=8, n=4)
    args, kw = k.make_example(key)
    y, h = k.run(*args, version="cuda", config=None, device=torch.device("cpu"),
                 **kw)
    assert y.shape == (2, 16, 8) and h.shape == (2, 8, 4)
    assert bool(torch.isfinite(y).all())

