"""The `jax.random` calls of the serving path, on torch tensors — the
counterpart of the Threefry-2x32 PRNG the JAX package samples with
(`repro.serve.engine` :284, :395-431 and `repro.serve.spec` :53-125).

Taken from jax 0.9.0 (`jax/_src/prng.py`: `threefry_seed` :802,
`threefry_2x32` :1092, `_threefry_fold_in` :1168,
`_threefry_random_bits_partitionable` :1184; `jax/_src/random.py`:
`uniform` / `_uniform` :401 / :435, `_gumbel` :1723, `categorical`
:1739), with the settings the reference runs under: 64-bit types off,
`jax_threefry_partitionable = True` (jax's default since 0.5) and the
"low" Gumbel mode (`jax_high_dynamic_range_gumbel = False`).

A key is the raw `PRNGKey` pair [hi, lo] of uint32 values, held as an
int64 tensor of shape (..., 2): a leading batch of keys draws row by row,
as `jax.vmap` over keys would. Every function works on the device of the
tensor it is given, and the card and the CPU give the same bits: CUDA has
almost no uint32 arithmetic, so the rounds run in int64 masked to 32 bits
(a sum of two 32-bit values, or a value shifted left by at most 29 bits,
stays below 2^63). The floats follow the reference's float32 points:
`uniform` builds them from the mantissa bits in float32; `gumbel`'s two
logarithms are each taken in float64 and rounded to float32, where jax
takes them in float32: jax's float32 log is one ulp off the rounded
value at ~14% of inputs, so a value lies within 2 float32 ulps of
max(|g|, 1) of jax's (the inner log's ulp, divided by the inner value,
is at most 2^-23), and every device gives the same bits.

    key = prng_key(0, device="cpu")
    k = fold_in(fold_in(key, 7), 3)            # request 7, token 3
    tok = categorical(k, logits / 0.8)         # jax.random.categorical
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch import backend

MASK32 = 0xFFFFFFFF
# Threefry-2x32's key-schedule parity constant and rotation schedule
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal, jnp.finfo(float32).tiny: gumbel's lower bound
F32_TINY = 1.1754943508222875e-38

IntLike = Union[int, torch.Tensor]


def prng_key(seed: int, device=backend.DEFAULT_DEVICE) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`'s raw [hi, lo] pair under 64-bit types
    off: the seed is an int32, hi is 0 and lo its 32 bits."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not an int32 (64-bit types are "
                         "off in the reference)")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=backend.resolve_device(device))


def _u32(x: IntLike, device) -> torch.Tensor:
    """x as int64 values in [0, 2^32): a uint32 conversion (wraps)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def _hash(k1, k2, x0, x1):
    """The Threefry-2x32 block function, 20 rounds (jax's
    `_threefry2x32_lowering`), on int64 tensors holding uint32 values
    that broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def threefry_2x32(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """`prng.threefry_2x32(key, counts)` for one key (2,): the flat counts
    (padded with one 0 when odd) split into halves that are hashed as the
    two words, and the two outputs concatenated; same shape as counts."""
    flat = _u32(counts, key.device).reshape(-1)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x0, x1 = flat.chunk(2)
    o0, o1 = _hash(key[0], key[1], x0, x1)
    return torch.cat([o0, o1])[:n].reshape(counts.shape)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the hash of the count pair
    [0, uint32(data)] under key. key (..., 2); data an int or a tensor
    that broadcasts against key[..., 0]."""
    d = _u32(data, key.device)
    o0, o1 = _hash(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (32 bits, the partitionable layout):
    element i (row-major) hashes the count pair [i >> 32, i & 0xFFFFFFFF]
    and keeps the XOR of the two words. key (..., 2) -> key.shape[:-1] +
    shape, uint32 values in an int64 tensor."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k1 = key[..., 0, None]
    k2 = key[..., 1, None]
    o0, o1 = _hash(k1, k2, idx >> 32, idx & MASK32)
    return (o0 ^ o1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled and
    shifted, floored at minval. XLA fuses the scale and shift into one
    fused multiply-add; here the float32 product is exact in float64 and
    the sum is rounded to float32 from there."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, float32)` in the "low" mode:
    -log(-log(u)) of u = uniform(minval=tiny, maxval=1). Each log is
    taken in float64 and rounded to float32 (jax: a float32 log)."""
    u = uniform(key, shape, F32_TINY, 1.0)
    inner = torch.log(u.double()).float()
    return -torch.log((-inner).double()).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis: the
    argmax (first on ties) of gumbel(key, (V,)) + logits, in float32.
    key (..., 2), logits (..., V) -> (...,) int64."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits.float(), dim=-1)
