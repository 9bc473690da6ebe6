"""repro_torch's copy of the GPP problem against repro's: the same sizes,
constants and keys, and byte-identical inputs for every seed, so one
numpy input feeds both packages."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro.kernels.gpp import problem as jp
from repro_torch.kernels.gpp import problem as tp

# small shapes of every kind the tests use; SI214/SI510 are compared by
# field and by the source of make_inputs (generating them here would take
# gigabytes)
GEN_SIZES = [jp.TINY, jp.BENCH,
             jp.GppSize("s1", nbands=8, ngpown=8, ncouls=64),
             jp.GppSize("s2", nbands=16, ngpown=4, ncouls=128),
             jp.GppSize("s3", nbands=4, ngpown=16, ncouls=32),
             jp.GppSize("nw3", nbands=8, ngpown=8, ncouls=16, nw=3)]


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("size", GEN_SIZES, ids=lambda s: s.name)
def test_make_inputs_byte_identical(size, seed):
    tsize = tp.GppSize(**dataclasses.asdict(size))
    a = jp.make_inputs(size, seed=seed)
    b = tp.make_inputs(tsize, seed=seed)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_make_inputs_float32_byte_identical():
    a = jp.make_inputs(jp.TINY, seed=3, dtype=np.float32)
    b = tp.make_inputs(tp.TINY, seed=3, dtype=np.float32)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_make_inputs_source_identical():
    """The generator's body is the same code, so identity holds at every
    size, Si-214 and Si-510 included."""
    def body(fn):
        src = inspect.getsource(fn)
        return src[src.index('"""', src.index('"""') + 3):]
    assert body(jp.make_inputs) == body(tp.make_inputs)


def test_sizes_and_constants_match():
    assert set(jp.SIZES) == set(tp.SIZES)
    for name, js in jp.SIZES.items():
        ts = tp.SIZES[name]
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        assert js.key_dims() == ts.key_dims()
        assert js.inner_iters == ts.inner_iters
        assert js.total_flops() == ts.total_flops()
        assert js.min_hbm_bytes() == ts.min_hbm_bytes()
    assert [f.name for f in dataclasses.fields(jp.GppSize)] == \
        [f.name for f in dataclasses.fields(tp.GppSize)]
    for c in ("LIMITONE", "LIMITTWO", "TOL_ZERO", "NW"):
        assert getattr(jp, c) == getattr(tp, c), c


def test_to_tensors_is_the_planar_f32_cast():
    inp = tp.make_inputs(tp.TINY, seed=5)
    t = tp.to_tensors(inp, "cpu")
    for k, v in inp.items():
        assert t[k].dtype == torch.float32 and t[k].is_contiguous()
        assert np.array_equal(t[k].numpy(), v.astype(np.float32)), k
    # a tensor already of that dtype and device passes through as it is
    again = tp.to_tensors(t, "cpu")
    assert all(again[k] is t[k] for k in t)
    t64 = tp.to_tensors(inp, "cpu", torch.float64)
    assert np.array_equal(t64["wx"].numpy(), inp["wx"])


def test_size_of_names_registered_sizes():
    assert tp.size_of(tp.make_inputs(tp.TINY)) == tp.TINY
    custom = tp.size_of(tp.make_inputs(tp.GppSize("x", 4, 16, 32)))
    assert custom.name == "custom" and custom.key_dims() == "32x16x4x2"
