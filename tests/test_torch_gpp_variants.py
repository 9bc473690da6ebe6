"""v0–v5 of repro_torch (plain torch) against the JAX package's variants
and against the complex128 oracle, and the torch complex64 oracle against
ref_jnp — the same numpy inputs through both packages. Tolerance: the
max-norm relative error `_rel` of tests/test_gpp_kernel.py, RTOL 5e-5."""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.gpp import problem as jp
from repro.kernels.gpp import ref as jref
from repro.kernels.gpp import variants as jvariants
from repro_torch.kernels.gpp import problem as tp
from repro_torch.kernels.gpp import ref as tref
from repro_torch.kernels.gpp import variants as tvariants

RTOL = 5e-5

SIZES = [  # tests/test_gpp_kernel.py's shapes
    tp.GppSize("s1", nbands=8, ngpown=8, ncouls=64),
    tp.GppSize("s2", nbands=16, ngpown=4, ncouls=128),
    tp.GppSize("s3", nbands=4, ngpown=16, ncouls=32),
]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: s.name)
@pytest.mark.parametrize("version", list(tvariants.VARIANTS))
def test_variant_matches_jax_and_oracle(size, version):
    inp = tp.make_inputs(size, seed=1)
    ach, asx = tref.ref_numpy(inp)
    a, x = tvariants.VARIANTS[version](inp)
    assert a.dtype == torch.complex64 and a.shape == (size.nw,)
    assert _rel(a, ach) < RTOL, version
    assert _rel(x, asx) < RTOL, version
    ja, jx = jax.jit(jvariants.VARIANTS[version])(inp)
    assert _rel(a, np.asarray(ja)) < RTOL, version
    assert _rel(x, np.asarray(jx)) < RTOL, version


def test_variants_keep_tensor_device_and_accept_tensors():
    inp = tp.make_inputs(tp.TINY, seed=2)
    t = tp.to_tensors(inp, "cpu")
    for v, fn in tvariants.VARIANTS.items():
        a, x = fn(t)
        b, y = fn(inp)
        assert torch.equal(a, b) and torch.equal(x, y), v
        assert a.device.type == "cpu"


def test_ref_numpy_is_a_copy():
    inp = tp.make_inputs(tp.BENCH, seed=4)
    a, x = tref.ref_numpy(inp)
    ja, jx = jref.ref_numpy(inp)
    assert np.array_equal(a, ja) and np.array_equal(x, jx)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: s.name)
def test_ref_torch_matches_ref_jnp_and_oracle(size):
    inp = tp.make_inputs(size, seed=6)
    a, x = tref.ref_torch(inp)
    assert a.dtype == torch.complex64
    ach, asx = tref.ref_numpy(inp)
    assert _rel(a, ach) < RTOL and _rel(x, asx) < RTOL
    ja, jx = jref.ref_jnp(inp)
    assert _rel(a, np.asarray(ja)) < RTOL and _rel(x, np.asarray(jx)) < RTOL


def test_f32_error_budget_vs_complex128():
    """The precision claim of tests/test_gpp_kernel.py:162 for the port:
    planar f32 v5 within 1e-4 relative of the complex128 oracle at BENCH."""
    inp = tp.make_inputs(tp.BENCH, seed=0)
    ach, asx = tref.ref_numpy(inp)
    a, x = tvariants.v5(inp)
    assert _rel(a, ach) < 1e-4
    assert _rel(x, asx) < 1e-4


def test_same_inputs_as_jax_package():
    """The inputs these tests feed both packages are the JAX package's own."""
    a = jp.make_inputs(jp.TINY, seed=1)
    b = tp.make_inputs(tp.TINY, seed=1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
