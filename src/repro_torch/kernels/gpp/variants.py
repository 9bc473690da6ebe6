"""GPP optimization journey, steps v0–v5 (plain torch, planar f32) — the
port of `repro.kernels.gpp.variants`.

  v0  baseline: divides (2 real divides per complex division), abs()/sqrt
      in branch conditions, 3-way branch, streaming over igp.
  v1  divides -> reciprocals: one rcp per |.|^2 then multiplies.
  v2  3-way branch -> zero-init + 2 masked selects.
  v3  abs()/sqrt in conditions -> squared-magnitude compares.
  v4  serialize band (loop over band blocks), (ig,igp) planes kept hot.
  v5  hoist mat across iw.

These are plain-torch steps in the reference too (pure JAX there), so
they stay plain torch on the card; the JAX `lax.scan`s are Python loops.
v6–v10 are the hand-written CUDA kernels in gpp_cuda.py.

All variants take the planar input dict (numpy arrays or tensors; tensors
keep their device) and return (ach (nw,) complex64, asx (nw,) complex64).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels.gpp.problem import LIMITONE, LIMITTWO, TOL_ZERO

SQRT_LIMITONE = LIMITONE ** 0.5
SQRT_LIMITTWO = LIMITTWO ** 0.5


def _f32(inputs: Dict) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(torch.float32) for k, v in inputs.items()}


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


# ---------------------------------------------------------------------------
# the branch math, parameterized by the optimization step
# ---------------------------------------------------------------------------

def _body(wxv, wt_re, wt_im, eps_re, eps_im, wt2_re, wt2_im, om2_re, om2_im,
          *, use_div: bool, use_abs: bool, three_way: bool):
    """Everything per (iw, band) value wxv against the (ig,igp) planes.
    Returns (sch_re, sch_im, ssx_re, ssx_im)."""
    wd_re = wxv - wt_re
    wd_im = -wt_im
    wdiffr = wd_re * wd_re + wd_im * wd_im

    if use_div:
        # v0: two real divides per complex division (the long-latency path)
        delw_re = (wt_re * wd_re + wt_im * wd_im) / wdiffr
        delw_im = (wt_im * wd_re - wt_re * wd_im) / wdiffr
    else:
        # v1: one reciprocal, then multiplies
        rden = 1.0 / wdiffr
        delw_re = (wt_re * wd_re + wt_im * wd_im) * rden
        delw_im = (wt_im * wd_re - wt_re * wd_im) * rden

    delwr = delw_re * delw_re + delw_im * delw_im

    if use_abs:
        # v0–v2: abs() (sqrt) in the condition evaluation
        cond1 = (torch.sqrt(wdiffr) > SQRT_LIMITTWO) & \
                (torch.sqrt(delwr) < SQRT_LIMITONE)
    else:
        # v3: squared-magnitude compares
        cond1 = (wdiffr > LIMITTWO) & (delwr < LIMITONE)
    cond2 = delwr > TOL_ZERO

    # branch 1
    sch1_re, sch1_im = _cmul(delw_re, delw_im, eps_re, eps_im)
    cden1_re = wxv * wxv - wt2_re
    cden1_im = -wt2_im
    c1sq = cden1_re * cden1_re + cden1_im * cden1_im
    if use_div:
        ssx1_re = (om2_re * cden1_re + om2_im * cden1_im) / c1sq
        ssx1_im = (om2_im * cden1_re - om2_re * cden1_im) / c1sq
    else:
        r1 = 1.0 / c1sq
        ssx1_re = (om2_re * cden1_re + om2_im * cden1_im) * r1
        ssx1_im = (om2_im * cden1_re - om2_re * cden1_im) * r1

    # branch 2
    cd2_re, cd2_im = _cmul(wt2_re, wt2_im, 4.0 * (delw_re + 0.5), 4.0 * delw_im)
    c2sq = cd2_re * cd2_re + cd2_im * cd2_im
    c2sq = torch.where(c2sq == 0, 1.0, c2sq)
    n2_re, n2_im = _cmul(-om2_re, -om2_im, delw_re, delw_im)
    if use_div:
        ssx2_re = (n2_re * cd2_re + n2_im * cd2_im) / c2sq
        ssx2_im = (n2_im * cd2_re - n2_re * cd2_im) / c2sq
    else:
        r2 = 1.0 / c2sq
        ssx2_re = (n2_re * cd2_re + n2_im * cd2_im) * r2
        ssx2_im = (n2_im * cd2_re - n2_re * cd2_im) * r2

    zero = torch.zeros((), dtype=wdiffr.dtype, device=wdiffr.device)
    if three_way:
        # v0/v1: nested 3-way selection (mirrors the if/elif/else chain)
        sch_re = torch.where(cond1, sch1_re, torch.where(cond2, zero, zero))
        sch_im = torch.where(cond1, sch1_im, torch.where(cond2, zero, zero))
        ssx_re = torch.where(cond1, ssx1_re, torch.where(cond2, ssx2_re, zero))
        ssx_im = torch.where(cond1, ssx1_im, torch.where(cond2, ssx2_im, zero))
    else:
        # v2: zero-init + two masked fills (the paper's "After" block)
        m2 = (~cond1) & cond2
        sch_re = torch.where(cond1, sch1_re, zero)
        sch_im = torch.where(cond1, sch1_im, zero)
        ssx_re = torch.where(cond1, ssx1_re, torch.where(m2, ssx2_re, zero))
        ssx_im = torch.where(cond1, ssx1_im, torch.where(m2, ssx2_im, zero))
    return sch_re, sch_im, ssx_re, ssx_im


def _assemble(acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(4, nw) f32 sums (ach re/im, asx re/im) -> two complex64 (nw,)."""
    return torch.complex(acc[0], acc[1]), torch.complex(acc[2], acc[3])


# ---------------------------------------------------------------------------
# v0–v3: stream over igp (collapse(3) analogue), differ in instruction mix
# ---------------------------------------------------------------------------

def _gpp_igp_stream(inputs: Dict, *, use_div, use_abs, three_way
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    f = _f32(inputs)
    nw, _ = f["wx"].shape
    ngpown = f["wtilde_re"].shape[1]
    vcoul = f["vcoul"]
    acc = torch.zeros(4, nw, dtype=torch.float32, device=vcoul.device)

    for igp in range(ngpown):
        wt_re, wt_im = f["wtilde_re"][:, igp], f["wtilde_im"][:, igp]   # (ig,)
        eps_re, eps_im = f["eps_re"][:, igp], f["eps_im"][:, igp]
        am_re, am_im = f["aqsm_re"][igp], f["aqsm_im"][igp]             # (band,)
        wt2_re, wt2_im = _cmul(wt_re, wt_im, wt_re, wt_im)
        om2_re, om2_im = _cmul(wt2_re, wt2_im, eps_re, eps_im)

        # mat(ig, band) = conj(aqsm[igp,band]) * aqsn[ig,band]
        mat_re, mat_im = _cmul(f["aqsn_re"], f["aqsn_im"],
                               am_re[None, :], -am_im[None, :])
        wre = vcoul[:, None] * mat_re
        wim = vcoul[:, None] * mat_im

        for iw in range(nw):
            wxv = f["wx"][iw]                              # (band,)
            sch_re, sch_im, ssx_re, ssx_im = _body(
                wxv[None, :], wt_re[:, None], wt_im[:, None],
                eps_re[:, None], eps_im[:, None],
                wt2_re[:, None], wt2_im[:, None],
                om2_re[:, None], om2_im[:, None],
                use_div=use_div, use_abs=use_abs, three_way=three_way)
            cr, ci = _cmul(wre, wim, sch_re, sch_im)
            acc[0, iw] += torch.sum(cr)
            acc[1, iw] += torch.sum(ci)
            cr, ci = _cmul(wre, wim, ssx_re, ssx_im)
            acc[2, iw] += torch.sum(cr)
            acc[3, iw] += torch.sum(ci)
    return _assemble(acc)


# ---------------------------------------------------------------------------
# v4/v5: serialize band (loop over band blocks), (ig,igp) planes held hot
# ---------------------------------------------------------------------------

def _gpp_band_blocked(inputs: Dict, *, band_block: int = 32,
                      hoist_iw: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    f = _f32(inputs)
    nw, nbands = f["wx"].shape
    band_block = min(band_block, nbands)
    while nbands % band_block:
        band_block //= 2
    nblk = nbands // band_block
    vcoul = f["vcoul"]
    acc = torch.zeros(4, nw, dtype=torch.float32, device=vcoul.device)

    wt_re, wt_im = f["wtilde_re"], f["wtilde_im"]          # (ig, igp)
    eps_re, eps_im = f["eps_re"], f["eps_im"]
    # v5: hoist band/iw-invariant subexpressions out of all loops
    wt2_re, wt2_im = _cmul(wt_re, wt_im, wt_re, wt_im)
    om2_re, om2_im = _cmul(wt2_re, wt2_im, eps_re, eps_im)

    an_re_all = f["aqsn_re"].T.reshape(nblk, band_block, -1)
    an_im_all = f["aqsn_im"].T.reshape(nblk, band_block, -1)
    am_re_all = f["aqsm_re"].T.reshape(nblk, band_block, -1)
    am_im_all = f["aqsm_im"].T.reshape(nblk, band_block, -1)
    wx_all = f["wx"].reshape(nw, nblk, band_block).permute(1, 0, 2)

    for blk in range(nblk):
        an_re, an_im = an_re_all[blk], an_im_all[blk]      # (bb, ig)
        am_re, am_im = am_re_all[blk], am_im_all[blk]      # (bb, igp)
        wxb = wx_all[blk]                                  # (nw, bb)
        for b in range(band_block):

            def make_mat():
                mr, mi = _cmul(an_re[b][:, None], an_im[b][:, None],
                               am_re[b][None, :], -am_im[b][None, :])
                return vcoul[:, None] * mr, vcoul[:, None] * mi

            if hoist_iw:
                # v5: mat(ig,igp) computed once, reused across iw
                wre, wim = make_mat()
            for iw in range(nw):
                if not hoist_iw:
                    # v4: mat recomputed per iw (pre-hoist redundancy)
                    wre, wim = make_mat()
                sch_re, sch_im, ssx_re, ssx_im = _body(
                    wxb[iw, b], wt_re, wt_im, eps_re, eps_im,
                    wt2_re, wt2_im, om2_re, om2_im,
                    use_div=False, use_abs=False, three_way=False)
                cr, ci = _cmul(wre, wim, sch_re, sch_im)
                acc[0, iw] += torch.sum(cr)
                acc[1, iw] += torch.sum(ci)
                cr, ci = _cmul(wre, wim, ssx_re, ssx_im)
                acc[2, iw] += torch.sum(cr)
                acc[3, iw] += torch.sum(ci)
    return _assemble(acc)


# ---------------------------------------------------------------------------
# public variant table
# ---------------------------------------------------------------------------

v0 = functools.partial(_gpp_igp_stream, use_div=True, use_abs=True,
                       three_way=True)
v1 = functools.partial(_gpp_igp_stream, use_div=False, use_abs=True,
                       three_way=True)
v2 = functools.partial(_gpp_igp_stream, use_div=False, use_abs=True,
                       three_way=False)
v3 = functools.partial(_gpp_igp_stream, use_div=False, use_abs=False,
                       three_way=False)
v4 = functools.partial(_gpp_band_blocked, hoist_iw=False)
v5 = functools.partial(_gpp_band_blocked, hoist_iw=True)

VARIANTS = {"v0": v0, "v1": v1, "v2": v2, "v3": v3, "v4": v4, "v5": v5}
