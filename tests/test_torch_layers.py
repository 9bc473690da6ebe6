"""repro_torch.models.layers against repro.models.layers on the same numpy
inputs (made from a seed): rms_norm, apply_rope, swiglu, matmul, embed,
lm_logits, the init's tree, and the plain attention functions
(chunked_causal_attention with window/q_offset/kv_valid, decode_attention
with a shared and a per-row length).

Tolerances: f32 results (rope angles, lm_logits) within 1e-5 relative —
the two frameworks sum and evaluate sin/cos/pow in another order. bf16
results within one bf16 ulp of their magnitude (at most 2^-7 relative): both
round an f32 value to bf16 once, and an f32 difference in the last bits
can move that rounding by one step."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models import layers as J
from repro.models.registry import build_model as jbuild
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import layers as T
from repro_torch.models.registry import build_model

BF16_ULP = 2.0 ** -7     # a bf16 ulp is at most 2^-7 of the magnitude


def _pair(a: np.ndarray):
    """The same array for both frameworks (bf16 arrays keep their bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_bf16_close(got, want, ulps=1.0):
    g, w = _np(got), _np(want)
    scale = np.maximum(np.abs(w), np.abs(w).max() * 1e-3)
    assert np.all(np.abs(g - w) <= ulps * BF16_ULP * scale + 1e-30), \
        float(np.max(np.abs(g - w) / scale))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _bf16(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def test_rms_norm(rng):
    jx, tx = _pair(_bf16(rng, 3, 5, 64))
    js, ts = _pair((1 + 0.1 * rng.standard_normal(64)).astype(ml_dtypes.bfloat16))
    _assert_bf16_close(T.rms_norm(tx, ts, 1e-5), J.rms_norm(jx, js, 1e-5))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(rng, per_row):
    x = rng.standard_normal((2, 3, 16, 32)).astype(np.float32)
    if per_row:
        pos = rng.integers(0, 4000, (2, 1, 16)).astype(np.int32)
    else:
        pos = np.arange(100, 116, dtype=np.int32)
    jx, tx = _pair(x)
    jp, tp = _pair(pos)
    want = np.asarray(J.apply_rope(jx, jp, 1e6))
    got = T.apply_rope(tx, tp, 1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(T.rope_freqs(32, 1e6).numpy(),
                               np.asarray(J.rope_freqs(32, 1e6)), rtol=1e-6)


def test_matmul_and_swiglu(rng):
    jx, tx = _pair(_bf16(rng, 2, 7, 64))
    jwi, twi = _pair(_bf16(rng, 64, 96, scale=0.1))
    jwg, twg = _pair(_bf16(rng, 64, 96, scale=0.1))
    jwo, two = _pair(_bf16(rng, 96, 64, scale=0.1))
    got = T.matmul(tx, twi)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, J.matmul(jx, jwi))
    # swiglu rounds three times in bf16 (h, silu(g), the product) before
    # the down-projection: allow two ulps
    _assert_bf16_close(T.swiglu(tx, twi, twg, two),
                       J.swiglu(jx, jwi, jwg, jwo), ulps=2.0)


def test_embed_and_lm_logits(rng):
    jt, tt = _pair(_bf16(rng, 128, 64, scale=0.02))
    toks = rng.integers(0, 128, (2, 9))
    e = T.embed(torch.from_numpy(toks), tt)
    np.testing.assert_array_equal(_np(e), _np(J.embed(jnp.asarray(toks), jt)))
    jx, tx = _pair(_bf16(rng, 2, 1, 64))
    got = T.lm_logits(tx, tt.T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(J.lm_logits(jx, jt.T)),
                               rtol=1e-5, atol=1e-6)


def test_init_tree_matches_jax_paths_and_shapes():
    """The port's init builds the JAX tree (keys, shapes, dtypes) with
    N(0, 0.02) weights and the ones/zeros constants."""
    kw = dict(layers=2, d_model=64, vocab=128)
    cfg = reduce_config(get_config("qwen2-1.5b"), **kw)
    jp = jbuild(jreduce(jget("qwen2-1.5b"), **kw)).init_params(
        jax.random.PRNGKey(0))
    tp = build_model(cfg).init_params(0, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [str(p) for p, _ in jl] == [str(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16
    assert torch.equal(tp["layers"]["ln1"], torch.ones(2, 64, dtype=torch.bfloat16))
    assert torch.count_nonzero(tp["layers"]["attn"]["bq"]) == 0
    std = float(tp["layers"]["ffn"]["wi"].float().std())
    assert 0.018 < std < 0.022
    again = build_model(cfg).init_params(0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


# ---------------------------------------------------------------------------
# attention (repro_torch.models.attention against repro.models.attention)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,q_offset,chunk", [(0, 0, 512), (5, 0, 8),
                                                    (0, 4, 6)])
def test_chunked_causal_attention(rng, window, q_offset, chunk):
    """bf16 output within one bf16 ulp: both compute f32 scores, round p
    to bf16 and the output once."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    jq, tq = _pair(_bf16(rng, 2, 12, 4, 32))
    jk, tk = _pair(_bf16(rng, 2, 12 + q_offset, 2, 32))
    jv, tv = _pair(_bf16(rng, 2, 12 + q_offset, 2, 32))
    valid = np.ones((2, 12 + q_offset), bool)
    valid[1, :3] = False
    kw = dict(chunk=chunk, window=window, q_offset=q_offset)
    want = JA.chunked_causal_attention(jq, jk, jv, kv_valid=jnp.asarray(valid),
                                       **kw)
    got = TA.chunked_causal_attention(tq, tk, tv,
                                      kv_valid=torch.from_numpy(valid), **kw)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("per_row,window", [(False, 0), (True, 0), (True, 3)])
def test_decode_attention(rng, per_row, window):
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    jq, tq = _pair(_bf16(rng, 3, 1, 4, 32))
    jk, tk = _pair(_bf16(rng, 3, 16, 2, 32))
    jv, tv = _pair(_bf16(rng, 3, 16, 2, 32))
    clen = np.array([5, 16, 9], np.int32) if per_row else np.int32(11)
    want = JA.decode_attention(jq, jk, jv, jnp.asarray(clen), window=window)
    got = TA.decode_attention(tq, tk, tv, torch.from_numpy(np.asarray(clen)),
                              window=window)
    _assert_bf16_close(got, want)
