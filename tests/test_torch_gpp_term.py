"""GPP's rewritten term (csrc/gpp.cu's term(), transcribed in torch as
gpp_cuda.term_planes): the branch's numerator, denominator and
|denominator|^2 are chosen before the one reciprocal, and the band
invariants (wt_im^2, wt_re wt_im, wt2_im^2, 4 wt2) come hoisted
(gpp_cuda.hoisted). Held against

  * the reference's term order (`variants._body`, the transcription of
    pallas_gpp.py:140-177 the plain journey steps run) on the same planes,
    element by element: bit-equal, since every kept result goes through
    the same operations (a negation and a scaling by 4 are exact, and
    torch on the CPU rounds each operation as written);
  * the JAX package's `gpp_pallas` in interpret mode at TINY and BENCH,
    through the plain version that runs the new order (gpp_fused_plain):
    max-norm relative 1e-5 (the two sum in another order);
  * the complex128 oracle at the same sizes, within the f32 budget of
    tests/test_gpp_kernel.py (1e-4)."""

import numpy as np
import pytest
import torch

from repro.kernels.gpp import pallas_gpp as jpallas
from repro_torch.kernels.gpp import gpp_cuda, problem, ref, variants

PALLAS_RTOL = 1e-5
REF_RTOL = 1e-4


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def _planes(dtype, seed=0, n=(64, 48)):
    """Random wtilde/eps planes and vcoul, with every branch of the term
    taken at wx in [-3, 3]: cond1, cond2 and neither."""
    rng = np.random.default_rng(seed)
    t = {k: torch.from_numpy(rng.standard_normal(n)).to(dtype)
         for k in ("wtilde_re", "wtilde_im", "eps_re", "eps_im")}
    t["wtilde_im"] = t["wtilde_im"] * 0.3
    t["vcoul"] = torch.from_numpy(rng.random(n[0])).to(dtype)
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_term_bit_equal_to_the_reference_order(dtype):
    t = _planes(dtype)
    e = gpp_cuda.hoisted(t)
    branches = set()
    for wx in np.linspace(-3.0, 3.0, 41):
        wxv = torch.tensor(wx, dtype=dtype)
        got = gpp_cuda.term_planes(wxv, e)
        want = variants._body(wxv, e["wt_re"], e["wt_im"], e["eps_re"],
                              e["eps_im"], e["wt2_re"], e["wt2_im"],
                              e["om2_re"], e["om2_im"], use_div=False,
                              use_abs=False, three_way=False)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        branches |= {int(s) for s in (got[0] != 0).flatten()}
        branches |= {2 * int(s) for s in ((got[0] == 0) & (got[2] != 0)
                                          ).flatten()}
    assert branches >= {0, 1, 2}       # neither, cond1 and cond2 all taken


def test_hoisted_invariants_are_exact():
    t = _planes(torch.float32, seed=1)
    e = gpp_cuda.hoisted(t)
    assert torch.equal(e["wt2x4_re"] / 4, e["wt2_re"])
    assert torch.equal(e["wt2x4_im"] / 4, e["wt2_im"])
    assert torch.equal(e["wt_im_sq"], (-e["wt_im"]) * (-e["wt_im"]))
    assert torch.equal(e["wt2_im"] / 2, e["wt_re_im"])


@pytest.mark.parametrize("size", [problem.TINY, problem.BENCH],
                         ids=lambda s: s.name)
def test_new_term_order_matches_pallas(size):
    cfg = gpp_cuda.V9.clamped(size)
    inp = problem.make_inputs(size, seed=3)
    a, x = gpp_cuda.gpp_cuda(problem.to_tensors(inp, "cpu"), cfg)
    jcfg = jpallas.BlockConfig(cfg.name, cfg.blk_ig, cfg.blk_igp,
                               cfg.blk_band, cfg.aqsm_transposed,
                               fused_acc=cfg.fused_acc)
    ja, jx = jpallas.gpp_pallas(inp, jcfg, interpret=True)
    assert _rel(a, np.asarray(ja)) < PALLAS_RTOL
    assert _rel(x, np.asarray(jx)) < PALLAS_RTOL
    ach, asx = ref.ref_numpy(inp)
    assert _rel(a, ach) < REF_RTOL
    assert _rel(x, asx) < REF_RTOL
