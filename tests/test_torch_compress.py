"""The int8 all-reduce's scale: a true f32 division on either device.

`optim.compress` divides max|g| by 127 (and the dequantized sum by the
group size). PyTorch's CUDA true-divide kernel turns a Python-number
divisor into a multiply by its rounded reciprocal, x * fl(1/127), which
differs from x / 127 for ~5% of f32 x; the card's scale then sat one ulp
from the host's, and `allreduce_int8` on the card and on host copies of
the same grads were not bit-equal. The CPU tests hold the scale to
numpy's f32 quotient on maxima where the two roundings differ; the card
test (marked `cuda`, skips without a card) holds the card to the host on
such a maximum. The file imports nothing of jax."""

import numpy as np
import pytest
import torch

from repro_torch.dist.collectives import AxesGroup
from repro_torch.optim import compress


def _reciprocal_differs(m: np.ndarray) -> np.ndarray:
    """Where the CUDA kernel's m * fl(1/127) is not the f32 quotient."""
    recip = np.float32(1.0) / np.float32(127.0)
    return (m * recip) != (m / np.float32(127.0))


def _maxima(n=100_000, seed=0) -> np.ndarray:
    """f32 maxima drawn from [1e-4, 1), the ones where the two roundings
    of m / 127 differ."""
    m = np.random.default_rng(seed).uniform(1e-4, 1.0, n).astype(np.float32)
    return m[_reciprocal_differs(m)]


def _grad(m: np.float32, n=4096, seed=1) -> np.ndarray:
    """A leaf's grads in (-m, m) with m itself as the largest |g|."""
    g = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32) * m
    g = np.clip(g, -np.nextafter(m, 0), np.nextafter(m, 0))
    g[17] = m
    return g


def test_scale_is_the_f32_quotient():
    ms = _maxima()
    assert 0.03 < len(ms) / 100_000 < 0.07      # ~4.7% of the draws
    got = compress._div(torch.from_numpy(ms), 127.0).numpy()
    np.testing.assert_array_equal(got, ms / np.float32(127.0))
    n = np.arange(1, 9, dtype=np.float32) * ms[:8]
    np.testing.assert_array_equal(
        compress._div(torch.from_numpy(n), 3).numpy(), n / np.float32(3))
    for m in ms[:4]:
        g = {"w": torch.from_numpy(_grad(m))}
        _, scales, _ = compress.ef_int8_compress(
            g, compress.init_residual(g))
        assert scales["w"].item() == np.float32(m) / np.float32(127.0)


def test_allreduce_int8_one_rank_matches_numpy():
    """allreduce_int8 over a group of one on the host: the numpy f32
    arithmetic with the scale divided, bit for bit."""
    m = _maxima()[0]
    g = _grad(m)
    out, res = compress.allreduce_int8(
        {"w": torch.from_numpy(g)}, {"w": torch.zeros(g.shape)},
        AxesGroup(None, ("data",)))
    scale = np.float32(m) / np.float32(127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(out["w"].numpy(),
                                  q.astype(np.float32) * scale)
    np.testing.assert_array_equal(res["w"].numpy(),
                                  g - q.astype(np.float32) * scale)


@pytest.mark.cuda
def test_allreduce_int8_card_bit_equal_to_host():
    """On a maximum where m * fl(1/127) != m / 127, allreduce_int8 over a
    group of one on the card and on the host copy agree bit for bit (out
    and residual), and so does ef_int8_compress."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    group = AxesGroup(None, ("data",))
    for m in _maxima()[:8]:
        g = _grad(m)
        dev = {"w": torch.from_numpy(g).cuda()}
        host = {"w": torch.from_numpy(g)}
        o_dev, r_dev = compress.allreduce_int8(
            dev, compress.init_residual(dev), group)
        o_cpu, r_cpu = compress.allreduce_int8(
            host, compress.init_residual(host), group)
        np.testing.assert_array_equal(o_dev["w"].cpu().numpy(),
                                      o_cpu["w"].numpy())
        np.testing.assert_array_equal(r_dev["w"].cpu().numpy(),
                                      r_cpu["w"].numpy())
        q_dev, s_dev, e_dev = compress.ef_int8_compress(
            dev, compress.init_residual(dev))
        q_cpu, s_cpu, e_cpu = compress.ef_int8_compress(
            host, compress.init_residual(host))
        assert s_dev["w"].item() == s_cpu["w"].item()
        assert torch.equal(q_dev["w"].cpu(), q_cpu["w"])
        assert torch.equal(e_dev["w"].cpu(), e_cpu["w"])
