"""The port's CUDA kernels on a card: each against its plain version
partial by partial, and against the complex128 oracle, at BENCH and at
small, ragged shapes. Every test here needs a CUDA card with sm_90a and
skips without one; the file imports nothing of jax, so it runs on a
machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gpp_cuda.py

Tolerance: max-norm relative error. The kernel and its plain version sum
in another order: partials within 1e-4 at these sizes (as chip_smoke.py
holds them at BENCH); totals against the oracle within 1e-4, the f32
budget of tests/test_gpp_kernel.py:162."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.gpp import gpp_cuda, problem, ref

CARD_RTOL = 1e-4
SMALL_ODD = problem.GppSize("s2", nbands=16, ngpown=4, ncouls=128)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    return torch.device("cuda")


CARD_CASES = [
    ("gpp_fused", gpp_cuda.V9, problem.BENCH),
    ("gpp_banded", gpp_cuda.V6, problem.BENCH),
    ("gpp_banded", gpp_cuda.V8, problem.BENCH),
    ("gpp_fused", gpp_cuda.V9, problem.TINY),           # clamped, masked
    ("gpp_banded", gpp_cuda.V6, SMALL_ODD),             # ngpown=4
    ("gpp_fused", gpp_cuda.BlockConfig("odd", 8, 32, 4, True, True, 96),
     problem.BENCH),                                    # threads not a divisor
    # the rewritten term (one reciprocal chosen before it is taken) under
    # the config dispatch tunes to at Si-214, and at 4 elements a thread
    ("gpp_fused", gpp_cuda.BlockConfig("tuned", 16, 32, 128, True, True, 512),
     problem.BENCH),
    ("gpp_fused", gpp_cuda.BlockConfig("ept4", 32, 64, 16, True, True, 512),
     problem.BENCH),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,base,size", CARD_CASES,
                         ids=lambda v: getattr(v, "name", v))
def test_kernel_matches_plain_on_card(cuda, name, base, size):
    cfg = base.clamped(size)
    inp = problem.make_inputs(size, seed=9)
    t = problem.to_tensors(inp, cuda)
    kern = getattr(gpp_cuda, name)
    plain = getattr(gpp_cuda, f"{name}_plain")
    before = kern.launches
    got = kern(t, cfg)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = plain(t, cfg)
    assert got.shape == want.shape
    assert _rel(got.cpu(), want.cpu().numpy()) < CARD_RTOL
    ach, asx = ref.ref_numpy(inp)
    s = got.reshape(-1, 4, size.nw).sum(0).cpu().double().numpy()
    assert _rel(s[0] + 1j * s[1], ach) < 1e-4
    assert _rel(s[2] + 1j * s[3], asx) < 1e-4
    # no atomics: a second launch repeats bit for bit
    assert torch.equal(kern(t, cfg), got)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    t = problem.to_tensors(problem.make_inputs(problem.TINY), cuda)
    cfg = gpp_cuda.V9.clamped(problem.TINY)
    with pytest.raises(ValueError):
        gpp_cuda.gpp_fused({**t, "wx": t["wx"].double()}, cfg)
    with pytest.raises(ValueError):
        gpp_cuda.gpp_fused({**t, "eps_re": t["eps_re"].T.contiguous().T}, cfg)
    with pytest.raises(ValueError):     # 32 elements a thread: not compiled
        gpp_cuda.gpp_fused(t, dataclasses.replace(cfg, blk_ig=64, threads=32))
    nw3 = problem.GppSize("nw3", nbands=8, ngpown=8, ncouls=64, nw=3)
    with pytest.raises(ValueError):
        gpp_cuda.gpp_fused(problem.to_tensors(problem.make_inputs(nw3), cuda),
                           gpp_cuda.V9.clamped(nw3))
