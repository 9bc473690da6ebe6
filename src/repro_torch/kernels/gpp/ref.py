"""GPP oracles.

`ref_numpy` — complex128 numpy, the precision reference (the paper's FP64);
              a copy of `repro.kernels.gpp.ref.ref_numpy`.
`ref_torch` — complex64 torch, the counterpart of `ref_jnp`: the same
              algorithm as one loop over bands, on any device.

Both implement the branch semantics documented in problem.py verbatim, with
divides and 3-way branching — i.e. the *v0 algorithm* in exact arithmetic.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.gpp.problem import LIMITONE, LIMITTWO, TOL_ZERO


def _complex_views(inputs: Dict):
    wtilde = inputs["wtilde_re"] + 1j * inputs["wtilde_im"]
    eps = inputs["eps_re"] + 1j * inputs["eps_im"]
    aqsn = inputs["aqsn_re"] + 1j * inputs["aqsn_im"]
    aqsm = inputs["aqsm_re"] + 1j * inputs["aqsm_im"]
    return wtilde, eps, aqsn, aqsm, inputs["wx"], inputs["vcoul"]


def ref_numpy(inputs: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """complex128 oracle. Returns (achtemp (nw,), asxtemp (nw,))."""
    wtilde, eps, aqsn, aqsm, wx, vcoul = _complex_views(inputs)
    wtilde = wtilde.astype(np.complex128)
    eps = eps.astype(np.complex128)
    aqsn = aqsn.astype(np.complex128)
    aqsm = aqsm.astype(np.complex128)
    wx = wx.astype(np.float64)
    vcoul = vcoul.astype(np.float64)

    nbands = aqsn.shape[1]
    nw = wx.shape[0]

    ach = np.zeros(nw, np.complex128)
    asx = np.zeros(nw, np.complex128)

    wtilde2 = wtilde * wtilde                          # (ig, igp)
    omega2 = wtilde2 * eps

    for iw in range(nw):
        for bb in range(nbands):                        # blocked for memory
            wxv = wx[iw, bb]                            # scalar
            wdiff = wxv - wtilde                        # (ig, igp)
            wdiffr = (wdiff * np.conj(wdiff)).real
            delw = wtilde * np.conj(wdiff) / np.maximum(wdiffr, 1e-300)
            delwr = (delw * np.conj(delw)).real

            cond1 = (wdiffr > LIMITTWO) & (delwr < LIMITONE)
            cond2 = (~cond1) & (delwr > TOL_ZERO)

            sch = np.where(cond1, delw * eps, 0.0)
            cden1 = wxv * wxv - wtilde2
            ssx1 = omega2 / np.where(cden1 == 0, 1.0, cden1)
            cden2 = 4.0 * wtilde2 * (delw + 0.5)
            ssx2 = -omega2 * delw / np.where(cden2 == 0, 1.0, cden2)
            ssx = np.where(cond1, ssx1, np.where(cond2, ssx2, 0.0))

            mat = np.conj(aqsm[:, bb])[None, :] * aqsn[:, bb][:, None]  # (ig, igp)
            w = vcoul[:, None] * mat
            ach[iw] += np.sum(w * sch)
            asx[iw] += np.sum(w * ssx)
    return ach, asx


def ref_torch(inputs: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """complex64 torch oracle (same algorithm; one loop step per band), on
    the inputs' device (numpy arrays: the CPU)."""
    f32 = {k: torch.as_tensor(v).to(torch.float32) for k, v in inputs.items()}
    wtilde = torch.complex(f32["wtilde_re"], f32["wtilde_im"])
    eps = torch.complex(f32["eps_re"], f32["eps_im"])
    aqsn = torch.complex(f32["aqsn_re"], f32["aqsn_im"])
    aqsm = torch.complex(f32["aqsm_re"], f32["aqsm_im"])
    wx = f32["wx"]
    vcoul = f32["vcoul"]
    nw, nbands = wx.shape

    wtilde2 = wtilde * wtilde
    omega2 = wtilde2 * eps
    zero = torch.zeros((), dtype=torch.complex64, device=wtilde.device)
    one = torch.ones((), dtype=torch.complex64, device=wtilde.device)

    ach = torch.zeros(nw, dtype=torch.complex64, device=wtilde.device)
    asx = torch.zeros(nw, dtype=torch.complex64, device=wtilde.device)
    for b in range(nbands):
        mat = torch.conj(aqsm[:, b])[None, :] * aqsn[:, b][:, None]
        w = vcoul[:, None] * mat
        da, dx = [], []
        for iw in range(nw):
            wxv = wx[iw, b]
            wdiff = wxv - wtilde
            wdiffr = (wdiff * torch.conj(wdiff)).real
            delw = wtilde * torch.conj(wdiff) / torch.clamp(wdiffr, min=1e-30)
            delwr = (delw * torch.conj(delw)).real
            cond1 = (wdiffr > LIMITTWO) & (delwr < LIMITONE)
            cond2 = (~cond1) & (delwr > TOL_ZERO)
            sch = torch.where(cond1, delw * eps, zero)
            cden1 = wxv * wxv - wtilde2
            ssx1 = omega2 / torch.where(cden1 == 0, one, cden1)
            cden2 = 4.0 * wtilde2 * (delw + 0.5)
            ssx2 = -omega2 * delw / torch.where(cden2 == 0, one, cden2)
            ssx = torch.where(cond1, ssx1, torch.where(cond2, ssx2, zero))
            da.append(torch.sum(w * sch))
            dx.append(torch.sum(w * ssx))
        ach = ach + torch.stack(da)
        asx = asx + torch.stack(dx)
    return ach, asx
