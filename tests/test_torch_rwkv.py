"""The port's rwkv6 pieces (`repro_torch.models.rwkv6` and the time and
channel mixes of `repro_torch.models.transformer`) against the JAX
package's on the same numpy inputs.

WKV forms (f32 on both sides): wkv6_scan, wkv6_decode and wkv6_chunked at
chunks 16, 32 and 64 and as one chunk of T < 64, at the decay of the
reference's own test (w = exp(-exp(N(0,1) - 1)), tests/
test_models_numerics.py:71); each within WKV_RTOL = 1e-5 of the largest
|JAX value| (the two sum their einsums in another order; measured
<= 1.6e-6). The port's chunked form is held to the JAX chunked form and
its scan to the JAX scan, never across: under the -60 clamp the chunked
form is not the scan (the pinned case at the model's initial decay).

token_shift and ddlerp are bit-equal. The time and channel mixes take
layer 0 of a reduced rwkv6-7b's JAX params (d_model 64, two heads of
32); the JAX side is compiled with xla_allow_excess_precision off (else
XLA keeps the bf16 token-shift mix in f32 across a fusion, where eager
torch rounds after each op, and the outputs move by a bf16 ulp). Outputs
(bf16) within MIX_ULPS = 2 bf16 ulps of the largest |JAX output|
(measured 0.018); the
wkv state within WKV_RTOL; the last tokens bit-equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as JT
from repro.models.registry import build_model as jbuild
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import convert
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import transformer as T

WKV_RTOL = 1e-5
MIX_ULPS = 2 * 2.0 ** -7
KW = dict(layers=2, d_model=64, vocab=128)


def _wkv_inputs(b, t, h, d, seed, decay="test"):
    """r, k, v (N(0,1)), w, u (0.3 N), s0 (0.1 N), float32 numpy. decay
    "test": w = exp(-exp(N - 1)), the reference test's; "init": w =
    exp(-exp(0.02 N)), the model's initial decay (w0 ~ 0.02 N)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    z = rng.standard_normal((b, t, h, d))
    wlog = z - 1 if decay == "test" else 0.02 * z
    w = np.exp(-np.exp(wlog)).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, d))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, d, d))).astype(np.float32)
    return r, k, v, w, u, s0


def _close(t, j, rtol=WKV_RTOL):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape
    err = float(np.max(np.abs(t - j)))
    assert err <= rtol * float(np.max(np.abs(j))), err


def _both(fn_t, fn_j, args, **kw):
    return (fn_t(*map(torch.from_numpy, args), **kw),
            fn_j(*map(jnp.asarray, args), **kw))


def test_wkv6_scan_matches_jax():
    args = _wkv_inputs(2, 40, 2, 16, seed=0)
    (ty, ts), (jy, js) = _both(rwkv.wkv6_scan, jrwkv.wkv6_scan, args)
    _close(ty, jy)
    _close(ts, js)


def test_wkv6_decode_matches_jax_and_the_scan():
    """One decode step equals JAX's, and the scan of T = 1."""
    r, k, v, w, u, s0 = _wkv_inputs(3, 1, 2, 16, seed=1)
    args = (r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s0)
    (ty, ts), (jy, js) = _both(rwkv.wkv6_decode, jrwkv.wkv6_decode, args)
    _close(ty, jy)
    _close(ts, js)
    sy, ss = rwkv.wkv6_scan(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    assert torch.equal(sy[:, 0], ty) and torch.equal(ss, ts)


@pytest.mark.parametrize("t,chunk", [(128, 16), (128, 32), (128, 64),
                                     (40, 40)])
def test_wkv6_chunked_matches_jax(t, chunk):
    """Chunks 16, 32, 64 and one chunk of T < 64 (the model's rule for a
    short prompt), from a nonzero state."""
    args = _wkv_inputs(2, t, 2, 16, seed=2)
    (ty, ts), (jy, js) = _both(rwkv.wkv6_chunked, jrwkv.wkv6_chunked, args,
                               chunk=chunk)
    _close(ty, jy)
    _close(ts, js)


def test_wkv6_chunked_rejects_a_ragged_t():
    args = _wkv_inputs(1, 40, 1, 8, seed=3)
    with pytest.raises(ValueError):
        rwkv.wkv6_chunked(*map(torch.from_numpy, args), chunk=16)


def test_clamp_pins_chunked_away_from_the_scan_at_the_initial_decay():
    """At the model's initial decay (w ~ e^-1 a step) the cumulative
    log-decay of a 64-step chunk reaches the -60 clamp at step ~60: the
    reference's chunked form then leaves its own scan by more than 0.1
    (y and state), from the last steps of the first chunk on (the
    carried state takes the error into the next chunk); the port's
    chunked form is the reference's chunked form, clamp and all."""
    r, k, v, w, u, _ = _wkv_inputs(1, 128, 2, 64, seed=4, decay="init")
    s0 = np.zeros((1, 2, 64, 64), np.float32)
    args = (r, k, v, w, u, s0)
    jy_c, js_c = jrwkv.wkv6_chunked(*map(jnp.asarray, args), chunk=64)
    jy_s, js_s = jrwkv.wkv6_scan(*map(jnp.asarray, args))
    gap = np.abs(np.asarray(jy_c) - np.asarray(jy_s)).max(axis=(0, 2, 3))
    assert gap.max() > 0.1
    assert float(np.abs(np.asarray(js_c) - np.asarray(js_s)).max()) > 0.1
    assert np.nonzero(gap > 1e-3)[0].min() >= 56
    assert gap[60:64].max() > 0.1 and gap[124:].max() > 0.1
    ty, ts = rwkv.wkv6_chunked(*map(torch.from_numpy, args), chunk=64)
    _close(ty, jy_c)
    _close(ts, js_c)


def test_token_shift_and_ddlerp_bit_equal():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 64)).astype(jnp.bfloat16)
    shift = rng.standard_normal((2, 64)).astype(jnp.bfloat16)
    mu = (0.5 * rng.standard_normal((2, 64))).astype(jnp.bfloat16)
    la = (0.1 * rng.standard_normal((64, 32))).astype(jnp.bfloat16)
    lb = (0.1 * rng.standard_normal((32, 64))).astype(jnp.bfloat16)
    tx, ts, tmu, tla, tlb = (convert.tensor_from_numpy(a, "cpu")
                             for a in (x, shift, mu, la, lb))
    tprev, tlast = rwkv.token_shift(tx, ts)
    jprev, jlast = jrwkv.token_shift(jnp.asarray(x), jnp.asarray(shift))
    for t, j in ((tprev, jprev), (tlast, jlast)):
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            np.asarray(j).view(np.uint16))
    jd = jax.jit(jrwkv.ddlerp).lower(
        jprev, jnp.asarray(x), jnp.asarray(mu), jnp.asarray(la),
        jnp.asarray(lb)).compile({"xla_allow_excess_precision": False})(
        jprev, jnp.asarray(x), jnp.asarray(mu), jnp.asarray(la),
        jnp.asarray(lb))
    td = rwkv.ddlerp(tprev, tx, tmu, tla, tlb)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jd).view(np.uint16))


@pytest.fixture(scope="module")
def layer0():
    """Layer 0 of a reduced rwkv6-7b's JAX params, on both sides."""
    jcfg = jreduce(jget("rwkv6-7b"), **KW)
    tcfg = reduce_config(get_config("rwkv6-7b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = jax.tree.map(lambda a: a[0], tp["layers"])
    return jcfg, tcfg, jl, tl


def _bf16(shape, seed, scale=1.0):
    a = scale * np.random.default_rng(seed).standard_normal(shape)
    return a.astype(jnp.bfloat16)


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _bits_close(t, j):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert t.shape == j.shape
    assert np.max(np.abs(t - j)) <= MIX_ULPS * np.max(np.abs(j))


@pytest.mark.parametrize("t", [1, 40, 64, 70])
def test_time_mix_matches_jax(layer0, t):
    """T = 1 decodes (wkv6_decode), 40 runs one chunk, 64 the 64-chunk
    path and 70 the sequential scan; from a nonzero shift input and
    state."""
    jcfg, tcfg, jl, tl = layer0
    decode = t == 1
    h, hd = tcfg.d_model // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    x, shift = _bf16((2, t, 64), 6), _bf16((2, 64), 7)
    s0 = (0.1 * np.random.default_rng(8).standard_normal(
        (2, h, hd, hd))).astype(np.float32)
    jfn = functools.partial(JT.rwkv_time_mix, cfg=jcfg, decode=decode)
    jo, jlast, js = _strict(lambda tm, a, b, c: jfn(tm, a, b, c),
                            jl["tm"], jnp.asarray(x), jnp.asarray(shift),
                            jnp.asarray(s0))
    to, tlast, ts = T.rwkv_time_mix(
        tl["tm"], convert.tensor_from_numpy(x, "cpu"),
        convert.tensor_from_numpy(shift, "cpu"), torch.from_numpy(s0), tcfg,
        decode=decode)
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    _bits_close(to, jo)
    _close(ts, js)
    np.testing.assert_array_equal(tlast.float().numpy(),
                                  np.asarray(jlast, np.float32))


@pytest.mark.parametrize("t", [1, 70])
def test_channel_mix_matches_jax(layer0, t):
    jcfg, tcfg, jl, tl = layer0
    x, shift = _bf16((2, t, 64), 9), _bf16((2, 64), 10)
    jo, jlast = _strict(JT.rwkv_channel_mix, jl["cm"], jnp.asarray(x),
                        jnp.asarray(shift))
    to, tlast = T.rwkv_channel_mix(tl["cm"],
                                   convert.tensor_from_numpy(x, "cpu"),
                                   convert.tensor_from_numpy(shift, "cpu"))
    assert to.dtype == torch.bfloat16
    _bits_close(to, jo)
    np.testing.assert_array_equal(tlast.float().numpy(),
                                  np.asarray(jlast, np.float32))
