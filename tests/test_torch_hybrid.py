"""The port's hybrid family (hymba) against the JAX package's, on the same
weights (the JAX params carried across with convert.params_from_numpy)
and the same numpy tokens, at the reduced hymba-1.5b (2 layers, d_model
64, vocab 128, window 64, N = 16): the param tree and its constant inits;
prefill logits and every cache leaf with ssm_impl "chunked" and "pallas"
(the JAX side runs its Pallas scan in interpret mode, the port the
kernel's plain version), "scan" and "stub"; a prefill longer than the
window and decode past it (the ring buffer, mirroring
tests/test_models_numerics.py:196); prefill_into_slot; and the engine's
greedy tokens, with batch-mates undisturbed (tests/test_serve.py:183).

Weights: at the init scale (0.02) the mamba state of this model stays
~1e-6 and the scan moves no logit in bf16, so a test of the scan would
prove nothing. The tests scale four mamba leaves of the JAX params
(ACTIVE: in_proj x5, conv_w x25, x_proj x10, dt_proj x10) before both
packages get them: the state then reaches ~0.6 and the SSM path moves the
logits by ~0.08 of their ~0.43.

Tolerances: logits (f32) within LOGIT_ATOL = 2e-2, as
tests/test_torch_model.py (bf16 activations; an activation can land one
bf16 ulp apart and that propagates). Cache k/v and conv (bf16) within 4
bf16 ulps of the leaf's largest value; h (f32, reached through bf16
activations) within H_RTOL = 2e-2 of its largest value. Measured at the
S = 64 prefill: logits 1.9e-3 apart (largest 0.43), k/v/conv up to 3.4e-3
and h 1.5e-3 of their largest values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.kernels.ssm import ssm_cuda
from repro_torch.models import convert
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine

LOGIT_ATOL = 2e-2
ULPS = 4 * 2.0 ** -7
H_RTOL = 2e-2
KW = dict(layers=2, d_model=64, vocab=128)
ACTIVE = {"in_proj": 5.0, "conv_w": 25.0, "x_proj": 10.0, "dt_proj": 10.0}


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("hymba-1.5b"), **KW)
    tcfg = reduce_config(get_config("hymba-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    mp = dict(jp["layers"]["mamba"])
    for k, f in ACTIVE.items():
        mp[k] = (mp[k].astype(jnp.float32) * f).astype(jnp.bfloat16)
    jp = {**jp, "layers": {**jp["layers"], "mamba": mp}}
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


def _models(weights, impl):
    jcfg, tcfg, jp, tp = weights
    return (jbuild(dataclasses.replace(jcfg, ssm_impl=impl)),
            build_model(dataclasses.replace(tcfg, ssm_impl=impl)), jp, tp)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL,
                               rtol=0)


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for key in ("k", "v", "conv"):
        t, j = tc[key].float().numpy(), np.asarray(jc[key], np.float32)
        assert t.shape == j.shape, key
        assert np.max(np.abs(t - j)) <= ULPS * np.max(np.abs(j)), key
    t, j = tc["h"].numpy(), np.asarray(jc["h"])
    assert tc["h"].dtype == torch.float32 and t.shape == j.shape
    assert np.max(np.abs(t - j)) <= H_RTOL * np.max(np.abs(j))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_param_tree_and_constant_inits(weights):
    """The port builds the JAX tree (paths and shapes), its constant inits
    (a_log, dt_bias, d, the norms) are the JAX package's bit for bit, and
    the carried weights keep their bits."""
    jcfg, tcfg, jp, tp = weights
    fresh_j = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    fresh_t = build_model(tcfg).init_params(0, device="cpu")
    for key in ("a_log", "dt_bias", "d", "norm_attn", "norm_ssm"):
        a = np.asarray(fresh_j["layers"]["mamba"][key]).view(np.uint16)
        b = fresh_t["layers"]["mamba"][key].view(torch.int16).numpy()
        np.testing.assert_array_equal(a, b.view(np.uint16))
    j_paths = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
               in jax.tree_util.tree_flatten_with_path(fresh_j)[0]}
    t_paths = {path: tuple(x.shape) for path, x in
               convert._flatten(fresh_t).items()}
    assert j_paths == t_paths
    a = np.asarray(jp["layers"]["mamba"]["x_proj"]).view(np.uint16)
    b = tp["layers"]["mamba"]["x_proj"].view(torch.int16).numpy()
    np.testing.assert_array_equal(a, b.view(np.uint16))


@pytest.mark.parametrize("impl", ["chunked", "pallas", "scan", "stub"])
def test_prefill_logits_and_cache(weights, impl):
    """S = 64 (a multiple of 64: "chunked" really chunks) for B = 2."""
    jm, tm, jp, tp = _models(weights, impl)
    toks = _tokens((2, 64))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 1, 128) and tl.dtype == torch.float32
    _logits_close(tl, jl)
    _cache_close(tc, jc)


def test_pallas_and_chunked_agree(weights):
    """The kernel route and the chunked route of the port give the same
    model: the first layer's state (both scans on the same f32 inputs)
    within 1e-4 of its largest value; the later layer's, whose inputs went
    through bf16 activations, within H_RTOL; the logits within
    LOGIT_ATOL."""
    _, tmc, _, tp = _models(weights, "chunked")
    _, tmp, _, _ = _models(weights, "pallas")
    toks = torch.from_numpy(_tokens((1, 128), seed=1)).long()
    lc, cc = tmc.prefill(tp, {"tokens": toks})
    lp, cp = tmp.prefill(tp, {"tokens": toks})
    _logits_close(lp, lc.numpy())
    for layer, tol in ((0, 1e-4), (1, H_RTOL)):
        assert float((cp["h"][layer] - cc["h"][layer]).abs().max()) <= \
            tol * float(cc["h"][layer].abs().max()), layer


def test_pallas_route_launches_the_kernel_wrapper(weights, monkeypatch):
    """ssm_impl="pallas" reaches ssm_cuda.ssm_scan once a layer (the
    wrapper takes its plain version on CPU tensors)."""
    _, tm, _, tp = _models(weights, "pallas")
    calls = []
    real = ssm_cuda.ssm_scan

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(ssm_cuda, "ssm_scan", spy)
    tm.prefill(tp, {"tokens": torch.from_numpy(_tokens((1, 40))).long()})
    assert calls == [(1, 40, 128)] * 2


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_ring_buffer_prefill_and_decode_past_the_window(weights, impl):
    """A prompt of w + 16 tokens (the prefill rolls its last w k/v lines
    into the ring), then decode across another wrap; each step against the
    JAX package, and the first against a fresh prefill of the longer
    prompt (the JAX test's 0.08 relative bound)."""
    jm, tm, jp, tp = _models(weights, impl)
    w = 64
    s = w + 16
    toks = _tokens((1, s + 1), seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s]).long()})
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    assert tc["k"].shape[2] == w
    feed = toks[:, s:s + 1]
    for step in range(w // 2 + 3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        if step == 0:
            full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
            err = float((tl - full).abs().max())
            assert err / (float(full.abs().max()) + 1e-6) < 0.08
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == s + w // 2 + 3


def test_short_prefill_then_decode_into_the_ring(weights):
    """A prompt shorter than the window fills lines 0..S-1; decode then
    writes lines S.. and wraps at w."""
    jm, tm, jp, tp = _models(weights, "pallas")
    s = 50
    toks = _tokens((2, s), seed=3)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tc["k"].shape[2] == s
    _cache_close(tc, jc)
    pad = [(0, 0), (0, 0), (0, 64 - s), (0, 0), (0, 0)]
    jc = {**jc, "k": jnp.pad(jc["k"], pad), "v": jnp.pad(jc["v"], pad)}
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    feed = _tokens((2, 1), seed=4)
    for _ in range(20):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)


def test_prefill_into_slot_writes_every_leaf(weights):
    """Two slots of a 3-row cache filled at their exact prompt lengths
    (one shorter and one longer than the window); every leaf's row is
    written, row 1 untouched; then per-row decode steps."""
    jm, tm, jp, tp = _models(weights, "pallas")
    B = 3
    jc = jm.init_cache(B, 128)
    jc["pos"] = jnp.zeros((B,), jnp.int32)
    tc = tm.init_cache(B, 128, device="cpu")
    tc["pos"] = torch.zeros((B,), dtype=torch.int32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for slot, plen in ((0, 30), (2, 90)):
        toks = _tokens((1, plen), seed=10 + slot)
        jl, jc = jm.prefill_into_slot(jp, jc, slot,
                                      {"tokens": jnp.asarray(toks)}, plen)
        tl, tc = tm.prefill_into_slot(tp, tc, slot,
                                      {"tokens": torch.from_numpy(toks).long()},
                                      plen)
        _logits_close(tl, jl)
    assert tc["pos"].tolist() == [30, 0, 90]
    _cache_close(tc, jc)
    for key in ("k", "v", "conv", "h"):
        assert not tc[key][:, 1].any(), key
        assert tc[key][:, 0].any() and tc[key][:, 2].any(), key
    feed = _tokens((B, 1), seed=5)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)


def test_prefill_rejects_pad_lens(weights):
    """pad_lens is refused; loss_fn runs (hybrid training) and its forward
    loss equals JAX's within 1e-3 (tests/test_torch_hybrid_train.py holds
    the gradients)."""
    jm, tm, jp, tp = _models(weights, "pallas")
    with pytest.raises(ValueError):
        tm.prefill(tp, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                        "pad_lens": torch.tensor([2])})
    toks = _tokens((1, 9), seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jtotal, _ = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met = tm.loss_fn(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert abs(float(total) - float(jtotal)) <= 1e-3
    assert float(met["ntokens"]) == 8


def test_engine_prefills_at_exact_length(weights):
    _, tcfg, _, tp = weights
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=128, device="cpu")
    assert [eng._bucket_len(n, 128) for n in (5, 9, 100)] == [5, 9, 100]
    with pytest.raises(ValueError):
        eng.run([Request(rid=0, prompt=np.arange(100), max_new_tokens=40)])


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_engine_greedy_tokens_match_jax(weights, impl):
    """The port's ServeEngine against the JAX engine on the same requests
    (more requests than slots, one prompt longer than the window): the
    same greedy tokens; and each request's tokens equal a solo run's, so
    batch-mates and slot refills do not disturb it."""
    jcfg, tcfg, jp, tp = weights
    jcfg = dataclasses.replace(jcfg, ssm_impl=impl)
    tcfg = dataclasses.replace(tcfg, ssm_impl=impl)
    specs = [(0, 5, 6), (1, 70, 9), (2, 12, 3), (3, 33, 7)]
    rng = np.random.default_rng(6)
    reqs = [(rid, rng.integers(0, 128, plen).astype(np.int32), n)
            for rid, plen, n in specs]
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=128)
    teng = ServeEngine(tcfg, tp, max_batch=2, cache_len=128, device="cpu")
    jout = jeng.run([JRequest(rid=r, prompt=p, max_new_tokens=n)
                     for r, p, n in reqs])
    tout = teng.run([Request(rid=r, prompt=p, max_new_tokens=n)
                     for r, p, n in reqs])
    assert tout == jout
    for r, p, n in reqs:
        solo = ServeEngine(tcfg, tp, max_batch=1, cache_len=128, device="cpu")
        assert solo.run([Request(rid=r, prompt=p, max_new_tokens=n)])[r] == \
            tout[r], r
