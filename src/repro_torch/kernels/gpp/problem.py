"""GPP (General Plasmon Pole) problem definition — the paper's kernel.

A copy of `repro.kernels.gpp.problem` (the port imports nothing of the JAX
package): the sizes, the constants and `make_inputs` are the same, so one
seed gives byte-identical numpy inputs to both packages. `to_tensors` is
the port's addition: the planar-f32 cast onto a device.

    do band = 1, nbands        # O(1000)
      do igp = 1, ngpown       # O(1000)
        do ig = 1, ncouls      # O(10000)
          do iw = 1, nw        # nw = 2
            wtilde = wtilde_array(ig,igp)
            wdiff  = wx_array(iw,band) - wtilde
            delw   = wtilde / wdiff
            ...branchy complex arithmetic...
            reduce into achtemp(iw), asxtemp(iw)

Inputs:
    wtilde (ncouls, ngpown) complex   I_eps (ncouls, ngpown) complex
    aqsn   (ncouls, nbands) complex   aqsm  (ngpown, nbands) complex
    wx     (nw, nbands)     real      vcoul (ncouls,)        real
Outputs:
    achtemp (nw,) complex   asxtemp (nw,) complex

Branch semantics per (ig, igp, band, iw):
    wdiff  = wx - wtilde ;  rden = 1/(wdiff*conj(wdiff))
    delw   = wtilde * conj(wdiff) * rden ; delwr = |delw|^2 ; wdiffr = |wdiff|^2
    if   wdiffr > limittwo and delwr < limitone:
         sch = delw * I_eps ; cden = wx^2 - wtilde^2 ; ssx = Omega2 / cden
    elif delwr > TOL_Zero:
         sch = 0 ; cden = 4*wtilde2*(delw + 0.5) ; ssx = -Omega2 * delw / cden
    else: sch = 0 ; ssx = 0
    mat = conj(aqsm[igp,band]) * aqsn[ig,band]
    achtemp[iw] += vcoul[ig] * mat * sch
    asxtemp[iw] += vcoul[ig] * mat * ssx
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

LIMITONE = 1.0 / (0.25 * 0.25)   # BerkeleyGW constants (to_f = 1/4)
LIMITTWO = 0.25 * 0.25
TOL_ZERO = 1e-12
NW = 2


@dataclasses.dataclass(frozen=True)
class GppSize:
    name: str
    nbands: int
    ngpown: int
    ncouls: int
    nw: int = NW

    @property
    def inner_iters(self) -> int:
        return self.nbands * self.ngpown * self.ncouls * self.nw

    def key_dims(self) -> str:
        """ProblemKey protocol (repro_torch.kernels.api): the tune-cache dims."""
        return f"{self.ncouls}x{self.ngpown}x{self.nbands}x{self.nw}"

    # analytic per-inner-iteration FLOP count for the branchless (v2+) form,
    # counted on the planar-f32 arithmetic (see variants.py):
    #   wdiff sub 2; |wdiff|^2 3; rcp 1 (div counts 1); delw 2 cmul-ish 8;
    #   |delw|^2 3; branch1: sch cmul 6, cden 5, |cden|^2+rcp 4, ssx 10;
    #   branch2: cden 8, ssx 12; selects ~8; mat cmul 6 (amortized /nw);
    #   accum 2x cmul+add 16.  ~= 90 flops / iter
    FLOPS_PER_ITER = 90.0

    def total_flops(self) -> float:
        return self.inner_iters * self.FLOPS_PER_ITER

    def min_hbm_bytes(self) -> float:
        """Compulsory traffic: read every input once (planar f32)."""
        b = 0
        b += 2 * 4 * self.ncouls * self.ngpown * 2   # wtilde, I_eps
        b += 2 * 4 * self.ncouls * self.nbands       # aqsn
        b += 2 * 4 * self.ngpown * self.nbands       # aqsm
        b += 4 * self.nw * self.nbands               # wx
        b += 4 * self.ncouls                         # vcoul
        b += 2 * 4 * self.nw * 2                     # outputs
        return float(b)


# Si-214 / Si-510 magnitudes per the paper (Sec. II-A: band,igp O(1000),
# ig O(10000); Si-510 is 3-4x larger on band/igp/ig). Exact BerkeleyGW
# sizes are not published in the paper, so representative magnitudes are
# used.
SI214 = GppSize("si214", nbands=1024, ngpown=1024, ncouls=8192)
SI510 = GppSize("si510", nbands=2560, ngpown=2560, ncouls=20480)
BENCH = GppSize("bench", nbands=64, ngpown=64, ncouls=512)
TINY = GppSize("tiny", nbands=8, ngpown=8, ncouls=64)   # tests

SIZES = {s.name: s for s in (SI214, SI510, BENCH, TINY)}


def make_inputs(size: GppSize, seed: int = 0, dtype=np.float64) -> Dict[str, np.ndarray]:
    """Random inputs in planar layout (dict of float arrays, numpy).

    Distributions chosen so all three branches are exercised: wdiff is near
    zero for a fraction of elements (branch 2/3), large otherwise.
    """
    rng = np.random.default_rng(seed)
    c = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s))
    wtilde = 0.5 * c(size.ncouls, size.ngpown) + 1.0
    i_eps = 0.3 * c(size.ncouls, size.ngpown)
    aqsn = c(size.ncouls, size.nbands) / np.sqrt(size.nbands)
    aqsm = c(size.ngpown, size.nbands) / np.sqrt(size.nbands)
    # wx near wtilde's magnitude so wdiff is sometimes small
    wx = rng.standard_normal((size.nw, size.nbands)) * 1.5 + 1.0
    vcoul = rng.random(size.ncouls) + 0.1
    out = {
        "wtilde_re": wtilde.real, "wtilde_im": wtilde.imag,
        "eps_re": i_eps.real, "eps_im": i_eps.imag,
        "aqsn_re": aqsn.real, "aqsn_im": aqsn.imag,
        "aqsm_re": aqsm.real, "aqsm_im": aqsm.imag,
        "wx": wx, "vcoul": vcoul,
    }
    return {k: v.astype(dtype) for k, v in out.items()}


def to_tensors(inputs: Dict, device, dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.Tensor]:
    """The planar input dict as contiguous tensors of `dtype` on `device`
    (the cast `gpp_pallas` makes with jnp.asarray(v, float32)). numpy
    arrays and tensors are both accepted; a tensor already of that dtype
    and device is returned as it is."""
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype).contiguous()
            for k, v in inputs.items()}


def size_of(inputs: Dict) -> GppSize:
    """The GppSize of a planar input dict (named if it matches a registered
    size, else 'custom')."""
    ncouls, ngpown = inputs["wtilde_re"].shape
    nw, nbands = inputs["wx"].shape
    for s in SIZES.values():
        if (s.ncouls, s.ngpown, s.nbands, s.nw) == (ncouls, ngpown, nbands, nw):
            return s
    return GppSize("custom", nbands=nbands, ngpown=ngpown, ncouls=ncouls, nw=nw)
