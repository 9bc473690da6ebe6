"""The port's Threefry sampling (`repro_torch.serve.rng`) against
`jax.random` on the same seeds: raw key bits, `fold_in` chains (the
engine's per-request keys and the four speculative-decoding salts),
`random_bits`, `uniform` and `categorical` bit-equal; `gumbel` within 2
float32 ulps of max(|g|, 1) (jax takes its two logs in float32, the port
rounds float64 logs: each within one ulp, and the outer log of a value
near 1 turns the inner log's ulp into at most 2^-23 absolute).

Shapes (), (1,), (7,), (128,) and (151936,) (qwen2's vocabulary), seeds 0,
1, 2^31 - 1 and -1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from _prop import given, settings, st
from repro.serve import spec as jspec
from repro_torch.serve import rng
from repro_torch.serve import spec as tspec

SEEDS = (0, 1, 2 ** 31 - 1, -1)
SHAPES = ((), (1,), (7,), (128,), (151936,))
SALTS = (jspec.SALT_DRAFT, jspec.SALT_ACCEPT, jspec.SALT_RESIDUAL,
         jspec.SALT_BONUS)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _keys(seed):
    return jax.random.PRNGKey(seed), rng.prng_key(seed, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_raw_bits(seed):
    jk, tk = _keys(seed)
    assert tk.dtype == torch.int64 and tk.shape == (2,)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))


def test_prng_key_refuses_seeds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        rng.prng_key(2 ** 31, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_chains_and_spec_salts(seed):
    """fold_in(fold_in(base, rid), n_gen) — the engine's sample key — and
    its four salted spec keys, for a spread of rids and token indices
    (2^31 and 2^32 - 1 wrap as uint32s)."""
    jk, tk = _keys(seed)
    for rid in (0, 1, 5, 1000, 2 ** 31, 2 ** 32 - 1):
        for n_gen in (0, 1, 31):
            jkey = jax.random.fold_in(jax.random.fold_in(jk, np.uint32(rid)),
                                      n_gen)
            tkey = rng.fold_in(rng.fold_in(tk, rid), n_gen)
            np.testing.assert_array_equal(_u32(tkey), np.asarray(jkey))
            for salt in SALTS:
                np.testing.assert_array_equal(
                    _u32(tspec.spec_sample_key(tk, rid, n_gen, salt)),
                    np.asarray(jspec.spec_sample_key(jk, np.uint32(rid),
                                                     n_gen, salt)))


def test_fold_in_batched_rows_equal_one_at_a_time():
    """A (B, 2) batch of keys folds per row, as jax.vmap does."""
    _, tk = _keys(3)
    rids = torch.tensor([0, 7, 9, 2 ** 31 + 5])
    keys = rng.fold_in(tk.expand(4, 2), rids)
    for i in range(4):
        np.testing.assert_array_equal(keys[i].numpy(),
                                      rng.fold_in(tk, int(rids[i])).numpy())


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_threefry_2x32_odd_and_even_counts(n):
    jk, tk = _keys(11)
    counts = np.arange(3, 3 + n, dtype=np.uint32) * 977
    np.testing.assert_array_equal(
        _u32(rng.threefry_2x32(tk, torch.from_numpy(counts.astype(np.int64)))),
        np.asarray(jprng.threefry_2x32(jk, counts)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_and_uniform_bit_equal(seed, shape):
    jk, tk = _keys(seed)
    key_j = jax.random.fold_in(jk, 17)
    key_t = rng.fold_in(tk, 17)
    bits = rng.random_bits(key_t, shape)
    assert bits.shape == shape
    np.testing.assert_array_equal(_u32(bits),
                                  np.asarray(jax.random.bits(key_j, shape)))
    u = rng.uniform(key_t, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        u.numpy().view(np.uint32),
        np.asarray(jax.random.uniform(key_j, shape)).view(np.uint32))
    lo, hi = 0.25, 3.0
    np.testing.assert_array_equal(
        rng.uniform(key_t, shape, lo, hi).numpy().view(np.uint32),
        np.asarray(jax.random.uniform(key_j, shape, minval=lo, maxval=hi)
                   ).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_two_ulps(seed, shape):
    jk, tk = _keys(seed)
    want = np.asarray(jax.random.gumbel(jax.random.fold_in(jk, 5), shape))
    got = rng.gumbel(rng.fold_in(tk, 5), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got.astype(np.float64) - want) <= 2 * ulp)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("vocab", [7, 128, 151936])
def test_categorical_bit_equal(seed, vocab):
    """categorical on the engine's keys and on logits / temperature, the
    engine's sample: the same token as jax, over 16 keys a case."""
    jk, tk = _keys(seed)
    lg = np.random.default_rng(vocab + (seed & 0xFF)).standard_normal(
        (16, vocab)).astype(np.float32) * 3.0
    for n_gen in range(16):
        jkey = jax.random.fold_in(jax.random.fold_in(jk, 4), n_gen)
        tkey = rng.fold_in(rng.fold_in(tk, 4), n_gen)
        row = lg[n_gen] / np.float32(0.8)
        want = int(jax.random.categorical(jkey, jnp.asarray(row)))
        got = rng.categorical(tkey, torch.from_numpy(row))
        assert got.dtype == torch.int64 and int(got) == want, n_gen


def test_categorical_batched_keys_draw_row_by_row():
    """A (B, 2) batch of keys over (B, V) logits: each row the draw of its
    own key (the engine's batched sampler), jax.vmap's layout."""
    jk, tk = _keys(0)
    lg = np.random.default_rng(1).standard_normal((5, 300)).astype(np.float32)
    rids = np.array([3, 1, 4, 1, 5])
    ngens = np.array([0, 2, 7, 1, 9])
    keys = rng.fold_in(rng.fold_in(tk.expand(5, 2), torch.from_numpy(rids)),
                       torch.from_numpy(ngens))
    got = rng.categorical(keys, torch.from_numpy(lg)).numpy()
    jkeys = jax.vmap(lambda r, n: jax.random.fold_in(
        jax.random.fold_in(jk, r), n))(jnp.asarray(rids), jnp.asarray(ngens))
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(lg)))
    np.testing.assert_array_equal(got, want)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=-2 ** 31, max_value=2 ** 31 - 1),
       data=st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_fold_in_and_uniform_property(seed, data):
    jk, tk = _keys(seed)
    jkey = jax.random.fold_in(jk, np.uint32(data))
    tkey = rng.fold_in(tk, data)
    np.testing.assert_array_equal(_u32(tkey), np.asarray(jkey))
    assert float(rng.uniform(tkey)) == float(jax.random.uniform(jkey))
