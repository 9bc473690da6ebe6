"""The port's dense model against the JAX package's, on the same weights
(the JAX params carried across with convert.params_from_numpy) and the
same numpy tokens: prefill logits (plain and left-padded with pad_lens),
four decode steps (a shared scalar pos, then per-row positions in a slot
cache), and the cache lines prefill_into_slot writes — each with
`use_flash_attention` off and on at S = 256, where the JAX side runs its
Pallas kernel in interpret mode and the port the kernel's plain version.

Tolerances: logits (f32, magnitude ~1) within LOGIT_ATOL = 2e-2. Both
sides round activations to bf16 after every product, norm and residual;
the frameworks sum in another order, so an activation can land one bf16
ulp (up to 2^-7 of its magnitude) apart, and that propagates through the
layers (measured: ~2e-3 here). Cache lines (bf16 k/v after rope) within
4 bf16 ulps of the largest line value, for the same reason."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import convert
from repro_torch.models.registry import build_model

LOGIT_ATOL = 2e-2
KV_ULPS = 4 * 2.0 ** -7
SEQ = 256
KW = dict(layers=2, d_model=64, vocab=128)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("qwen2-1.5b"), **KW)
    tcfg = reduce_config(get_config("qwen2-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


def _models(weights, flash):
    jcfg, tcfg, jp, tp = weights
    jm = jbuild(dataclasses.replace(jcfg, use_flash_attention=flash))
    tm = build_model(dataclasses.replace(tcfg, use_flash_attention=flash))
    return jm, tm, jp, tp


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL,
                               rtol=0)


def _kv_close(t, j):
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    assert np.max(np.abs(t - j)) <= KV_ULPS * np.max(np.abs(j))


def test_params_round_trip_bits(weights):
    jcfg, tcfg, jp, tp = weights
    a = np.asarray(jp["layers"]["attn"]["wq"]).view(np.uint16)
    b = tp["layers"]["attn"]["wq"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bad = jax.tree.map(np.asarray, jp)
        del bad["final_norm"]
        convert.params_from_numpy(bad, tcfg, device="cpu")


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_logits_and_cache(weights, flash):
    jm, tm, jp, tp = _models(weights, flash)
    toks = _tokens((2, SEQ))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 1, 128) and tl.dtype == torch.float32
    _logits_close(tl, jl)
    _kv_close(tc["k"], jc["k"])
    _kv_close(tc["v"], jc["v"])
    assert int(tc["pos"]) == int(jc["pos"]) == SEQ


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_pad_lens(weights, flash):
    """Left padding with pad_lens: kv_valid is set, so both sides take the
    chunked path even with flash on — and match each other and the
    unpadded prompt's logits."""
    jm, tm, jp, tp = _models(weights, flash)
    toks = _tokens((2, SEQ), seed=1)
    pads = np.array([0, 37], np.int32)
    toks[1, :37] = 0
    batch_j = {"tokens": jnp.asarray(toks), "pad_lens": jnp.asarray(pads)}
    batch_t = {"tokens": torch.from_numpy(toks).long(),
               "pad_lens": torch.from_numpy(pads)}
    jl, _ = jm.prefill(jp, batch_j)
    tl, _ = tm.prefill(tp, batch_t)
    _logits_close(tl, jl)
    solo, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks[1:, 37:]).long()})
    _logits_close(tl[1:], solo.numpy())


@pytest.mark.parametrize("flash", [False, True])
def test_four_decode_steps_shared_pos(weights, flash):
    jm, tm, jp, tp = _models(weights, flash)
    toks = _tokens((2, SEQ), seed=2)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    room = 8

    def grow(c, pad):
        return {k: (pad(v) if k != "pos" else v) for k, v in c.items()}

    jc = grow(jc, lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, room), (0, 0),
                                        (0, 0))))
    tc = grow(tc, lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, room)))
    feed = _tokens((2, 1), seed=3)
    for step in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        assert int(tc["pos"]) == int(jc["pos"]) == SEQ + step + 1
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _kv_close(tc["k"], jc["k"])


@pytest.mark.parametrize("flash", [False, True])
def test_slot_prefill_then_per_row_decode(weights, flash):
    """prefill_into_slot writes one row's lines (right-padded to S=256,
    the flash condition) and pos; then four per-row decode steps, rows at
    their own offsets."""
    jm, tm, jp, tp = _models(weights, flash)
    B, LC = 3, 272
    jc = jm.init_cache(B, LC)
    jc["pos"] = jnp.zeros((B,), jnp.int32)
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert tc["k"].shape == (2, B, LC, 1, 32) and tc["pos"].shape == (B,)
    for slot, plen in ((0, 200), (2, 256)):
        toks = np.zeros((1, SEQ), np.int32)
        toks[0, :plen] = _tokens((plen,), seed=10 + slot)
        jl, jc = jm.prefill_into_slot(jp, jc, slot, {"tokens": jnp.asarray(toks)},
                                      plen)
        tl, tc = tm.prefill_into_slot(tp, tc, slot,
                                      {"tokens": torch.from_numpy(toks).long()},
                                      plen)
        _logits_close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].tolist() == [200, 0, 256]
    _kv_close(tc["k"], jc["k"])
    _kv_close(tc["v"], jc["v"])
    assert not tc["k"][:, 1].any()                  # row 1 untouched
    feed = _tokens((B, 1), seed=4)
    for _ in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _kv_close(tc["k"], jc["k"])
