"""GPP kernels for Hopper — the port of `repro.kernels.gpp.pallas_gpp`:
the v6 (cache blocking), v7 (index swap), v8 (block-size tuning) and v9
(fused accumulation) steps as two hand-written CUDA kernels in
`repro_torch/csrc/gpp.cu`, their launchers, plain-torch versions and the
traffic model.

  gpp_fused   v9/v10: grid (igp tiles, ig tiles); each block sweeps every
              band with its elements' wtilde/eps/wt²/Ω² held in registers
              and writes one (4, nw) partial.
  gpp_banded  v6–v8: grid (igp tiles, ig tiles, band blocks); each block
              sweeps one band block and writes its own partial, re-reading
              wtilde/eps per band block. v6 reads aqsm from the
              (ngpown, nbands) array in place (strided); v7/v8 read the
              (nbands, ngpown) transpose.

A wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain version for CPU tensors; the plain versions (`gpp_fused_plain`,
`gpp_banded_plain`) do the same block decomposition in torch and return
the same partials array, so the card can compare partial by partial.
`gpp_cuda` sums the partials to (ach, asx) complex64, as `gpp_pallas`
sums its outputs outside the kernel.

BlockConfig keeps the Pallas fields; `threads` is the block's thread
count, and a thread owns ceil(blk_ig*blk_igp / threads) elements. The
TPU's VMEM budget becomes Hopper's: shared memory per block
(`smem_bytes`, ≤ 232,448 B) and registers (`regs_estimate`, ≤ 255 a
thread, ≤ 65,536 a block).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gpp.problem import (LIMITONE, LIMITTWO, TOL_ZERO,
                                             GppSize)

SMEM_PER_BLOCK = 232_448          # Hopper opt-in dynamic shared memory
REGS_PER_THREAD = 255
MAX_THREADS = 1024
EPT_INSTANCES = (1, 2, 4, 8)      # elements a thread owns, compiled in gpp.cu
NW_INSTANCES = (2,)               # nw values compiled in gpp.cu
RED_SMEM_BYTES = 32 * 4 * 4       # static block-reduction scratch, per nw
REGS_PER_SM = 65_536
# registers a thread of each compiled instance, by elements a thread owns
# (the most of its fused/banded and aqsm-layout instances), as nvcc -O3
# (12.8) lays out gpp.cu for sm_90a: chip_smoke.py prints the compiled
# counts (kernel_attrs) beside these, and the launcher checks the compiled
# count before each launch
REGS_BY_EPT = {1: 54, 2: 77, 4: 96, 8: 176}
# IEEE reciprocals one (ig, igp, band, iw) term of csrc/gpp.cu takes (the
# SASS census divides the band loop's MUFU.RCP by it)
RECIPROCALS_PER_TERM = 2

@dataclasses.dataclass(frozen=True)
class BlockConfig:
    name: str
    blk_ig: int
    blk_igp: int
    blk_band: int
    aqsm_transposed: bool    # v7/v8 layout swap
    fused_acc: bool = False  # v9+: one partial per (igp, ig) tile, all bands
    threads: int = 256

    def elems_per_thread(self) -> int:
        return -(-self.blk_ig * self.blk_igp // self.threads)

    def ept_instance(self) -> int:
        """The compiled elements-per-thread instance this config runs on
        (elements_per_thread rounded up to a power of two)."""
        return 1 << max(self.elems_per_thread() - 1, 0).bit_length()

    def smem_bytes(self, nw: int = 2) -> int:
        """Shared memory a block uses: the staged aqsnᵀ, aqsm and wx
        chunk plus the reduction scratch."""
        staged = 4 * self.blk_band * (2 * self.blk_ig + 2 * self.blk_igp + nw)
        return staged + RED_SMEM_BYTES * nw

    def regs_estimate(self) -> int:
        """Registers a thread of the instance this config runs on."""
        return REGS_BY_EPT.get(self.ept_instance(), REGS_PER_THREAD + 1)

    def clamped(self, size: GppSize) -> "BlockConfig":
        """Shrink blocks to fit a smaller problem (power-of-two dims keep
        divisibility; the launcher re-checks it), and the thread count to
        the tile so that no warp is idle."""
        blk_ig = min(self.blk_ig, size.ncouls)
        blk_igp = min(self.blk_igp, size.ngpown)
        threads = min(self.threads, -(-blk_ig * blk_igp // 32) * 32)
        return dataclasses.replace(
            self, blk_ig=blk_ig, blk_igp=blk_igp,
            blk_band=min(self.blk_band, size.nbands), threads=threads)


# Hopper journey configs. The TPU tiles (512x128 elements at 8 live floats
# each) do not fit a block's registers, so each step is re-chosen:
# v6 -> v7 differs only in aqsm's layout, v7 -> v8 only in block shape
# (tile, band block and threads: 4 elements a thread -> 1, so a SM holds
# twice the warps), v8 -> v9 only in fusion.
V6 = BlockConfig("v6", blk_ig=16, blk_igp=64, blk_band=8, aqsm_transposed=False)
V7 = BlockConfig("v7", blk_ig=16, blk_igp=64, blk_band=8, aqsm_transposed=True)
V8 = BlockConfig("v8", blk_ig=16, blk_igp=32, blk_band=64, aqsm_transposed=True,
                 threads=512)
# v9: v8's blocks + fused accumulation. v10 is v9 under whatever
# BlockConfig repro_torch.tune picks per size.
V9 = BlockConfig("v9", blk_ig=16, blk_igp=32, blk_band=64,
                 aqsm_transposed=True, fused_acc=True, threads=512)

CONFIGS = {"v6": V6, "v7": V7, "v8": V8, "v9": V9}

_KEYS = ("wtilde_re", "wtilde_im", "eps_re", "eps_im", "aqsn_re", "aqsn_im",
         "aqsm_re", "aqsm_im", "wx", "vcoul")


def check_tiles(size: GppSize, cfg: BlockConfig) -> Tuple[int, int, int]:
    """(n_igp, n_ig, n_b) grid of `cfg` over `size`; raises AssertionError
    (as `gpp_pallas` asserts) when a block does not tile its axis."""
    for axis, n, blk in (("ncouls", size.ncouls, cfg.blk_ig),
                         ("ngpown", size.ngpown, cfg.blk_igp),
                         ("nbands", size.nbands, cfg.blk_band)):
        if blk <= 0 or n % blk:
            raise AssertionError((axis, n, blk))
    return (size.ngpown // cfg.blk_igp, size.ncouls // cfg.blk_ig,
            size.nbands // cfg.blk_band)


def _size(t: Dict[str, torch.Tensor]) -> GppSize:
    ncouls, ngpown = t["wtilde_re"].shape
    nw, nbands = t["wx"].shape
    want = {"wtilde_re": (ncouls, ngpown), "wtilde_im": (ncouls, ngpown),
            "eps_re": (ncouls, ngpown), "eps_im": (ncouls, ngpown),
            "aqsn_re": (ncouls, nbands), "aqsn_im": (ncouls, nbands),
            "aqsm_re": (ngpown, nbands), "aqsm_im": (ngpown, nbands),
            "wx": (nw, nbands), "vcoul": (ncouls,)}
    device = t["wtilde_re"].device
    for k, shape in want.items():
        if tuple(t[k].shape) != shape:
            raise ValueError(f"{k}: shape {tuple(t[k].shape)}, expected {shape}")
        if t[k].device != device:
            raise ValueError(f"{k} on {t[k].device}, wtilde_re on {device}")
    return GppSize("custom", nbands=nbands, ngpown=ngpown, ncouls=ncouls, nw=nw)


# ---------------------------------------------------------------------------
# plain versions (torch): the kernels' block decomposition, same partials
# ---------------------------------------------------------------------------

def hoisted(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The (ncouls, ngpown) planes csrc/gpp.cu's Elem holds for a whole
    band sweep: wtilde, eps, vcoul (as a column), wt2 = wtilde^2, om2 =
    wt2 eps, and the term's own band invariants wt_im^2, wt_re wt_im,
    wt2_im^2 and 4 wt2."""
    wt_re, wt_im = t["wtilde_re"], t["wtilde_im"]
    eps_re, eps_im = t["eps_re"], t["eps_im"]
    wt2_re = wt_re * wt_re - wt_im * wt_im
    wt2_im = 2.0 * wt_re * wt_im
    return {"wt_re": wt_re, "wt_im": wt_im, "eps_re": eps_re,
            "eps_im": eps_im, "vc": t["vcoul"][:, None],
            "wt2_re": wt2_re, "wt2_im": wt2_im,
            "om2_re": wt2_re * eps_re - wt2_im * eps_im,
            "om2_im": wt2_re * eps_im + wt2_im * eps_re,
            "wt_im_sq": wt_im * wt_im, "wt_re_im": wt_re * wt_im,
            "wt2_im_sq": wt2_im * wt2_im,
            "wt2x4_re": 4.0 * wt2_re, "wt2x4_im": 4.0 * wt2_im}


def term_planes(wxv, e: Dict[str, torch.Tensor]):
    """csrc/gpp.cu's term() for one (band, iw) value wxv over every
    element's planes `e` (`hoisted`), in its order: the branch's
    numerator, denominator and |denominator|^2 chosen before the one
    reciprocal, the band invariants taken from `e`. The same function as
    pallas_gpp.py:140-177 (the c2sq == 0 -> 1 guard, cond1 and cond2 as
    written). Returns (sch_re, sch_im, ssx_re, ssx_im)."""
    wd_re = wxv - e["wt_re"]
    wdiffr = wd_re * wd_re + e["wt_im_sq"]
    rden = 1.0 / wdiffr
    delw_re = (e["wt_re"] * wd_re - e["wt_im_sq"]) * rden
    delw_im = (e["wt_im"] * wd_re + e["wt_re_im"]) * rden
    delwr = delw_re * delw_re + delw_im * delw_im
    cond1 = (wdiffr > LIMITTWO) & (delwr < LIMITONE)
    keep = cond1 | (delwr > TOL_ZERO)
    zero = torch.zeros((), dtype=wdiffr.dtype, device=wdiffr.device)
    sch_re = torch.where(cond1, delw_re * e["eps_re"] - delw_im * e["eps_im"],
                         zero)
    sch_im = torch.where(cond1, delw_re * e["eps_im"] + delw_im * e["eps_re"],
                         zero)
    cden1_re = wxv * wxv - e["wt2_re"]
    c1sq = cden1_re * cden1_re + e["wt2_im_sq"]
    dh = delw_re + 0.5
    cd2_re = e["wt2x4_re"] * dh - e["wt2x4_im"] * delw_im
    cd2_im = e["wt2x4_re"] * delw_im + e["wt2x4_im"] * dh
    c2sq = cd2_re * cd2_re + cd2_im * cd2_im
    c2sq = torch.where(c2sq == 0, 1.0, c2sq)
    n2_re = -(e["om2_re"] * delw_re - e["om2_im"] * delw_im)
    n2_im = -(e["om2_re"] * delw_im + e["om2_im"] * delw_re)
    num_re = torch.where(cond1, e["om2_re"], n2_re)
    num_im = torch.where(cond1, e["om2_im"], n2_im)
    den_re = torch.where(cond1, cden1_re, cd2_re)
    den_im = torch.where(cond1, -e["wt2_im"], cd2_im)
    r = 1.0 / torch.where(cond1, c1sq, c2sq)
    ssx_re = torch.where(keep, (num_re * den_re + num_im * den_im) * r, zero)
    ssx_im = torch.where(keep, (num_im * den_re - num_re * den_im) * r, zero)
    return sch_re, sch_im, ssx_re, ssx_im


def _plain_partials(t: Dict[str, torch.Tensor], cfg: BlockConfig,
                    banded: bool) -> torch.Tensor:
    size = _size(t)
    n_igp, n_ig, n_b = check_tiles(size, cfg)
    e = hoisted(t)
    out = torch.zeros((n_igp, n_ig, n_b if banded else 1, 4, size.nw),
                      dtype=e["wt_re"].dtype, device=e["wt_re"].device)

    def tile_sums(plane):              # (ncouls, ngpown) -> (n_igp, n_ig)
        return plane.reshape(n_ig, cfg.blk_ig, n_igp, cfg.blk_igp
                             ).sum((1, 3)).T

    for b in range(size.nbands):
        an_re, an_im = t["aqsn_re"][:, b, None], t["aqsn_im"][:, b, None]
        am_re, am_im = t["aqsm_re"][None, :, b], t["aqsm_im"][None, :, b]
        wre = e["vc"] * (an_re * am_re + an_im * am_im)
        wim = e["vc"] * (an_im * am_re - an_re * am_im)
        slot = b // cfg.blk_band if banded else 0
        for iw in range(size.nw):
            sch_re, sch_im, ssx_re, ssx_im = term_planes(t["wx"][iw, b], e)
            for q, plane in enumerate((wre * sch_re - wim * sch_im,
                                       wre * sch_im + wim * sch_re,
                                       wre * ssx_re - wim * ssx_im,
                                       wre * ssx_im + wim * ssx_re)):
                out[:, :, slot, q, iw] += tile_sums(plane)
    return out if banded else out[:, :, 0]


def gpp_fused_plain(t: Dict[str, torch.Tensor], cfg: BlockConfig) -> torch.Tensor:
    """Plain version of gpp_fused: partials (n_igp, n_ig, 4, nw), rows
    (ach re, ach im, asx re, asx im), in the inputs' dtype and device."""
    return _plain_partials(t, cfg, banded=False)


def gpp_banded_plain(t: Dict[str, torch.Tensor], cfg: BlockConfig) -> torch.Tensor:
    """Plain version of gpp_banded: partials (n_igp, n_ig, n_b, 4, nw)."""
    return _plain_partials(t, cfg, banded=True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LP = ctypes.POINTER(ctypes.c_longlong)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from gpp.cu."""
    lib.gpp_launch.argtypes = [_I] * 5 + [_P] * 11 + [_I] * 6 + [_P]
    lib.gpp_launch.restype = _I
    lib.gpp_func_attrs.argtypes = [_I] * 4 + [ctypes.POINTER(_I)] * 2
    lib.gpp_func_attrs.restype = _I
    lib.gpp_launch_shape.argtypes = [_I] * 10 + [_LP] * 3
    lib.gpp_launch_shape.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("gpp.cu"))


def _check_launchable(t: Dict[str, torch.Tensor], cfg: BlockConfig,
                      size: GppSize) -> None:
    for k in _KEYS:
        x = t[k]
        if x.device.type != "cuda":
            raise ValueError(f"{k} is on {x.device}, the kernel needs CUDA")
        if x.dtype != torch.float32:
            raise ValueError(f"{k} is {x.dtype}, the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"{k} is not contiguous")
    if size.nw not in NW_INSTANCES:
        raise ValueError(f"nw={size.nw} not compiled (have {NW_INSTANCES})")
    if cfg.ept_instance() not in EPT_INSTANCES:
        raise ValueError(f"{cfg}: {cfg.elems_per_thread()} elements a thread "
                         f"(compiled: {EPT_INSTANCES})")
    if cfg.threads % 32 or not 32 <= cfg.threads <= MAX_THREADS:
        raise ValueError(f"{cfg}: threads must be a multiple of 32 up to "
                         f"{MAX_THREADS}")
    if cfg.smem_bytes(size.nw) > SMEM_PER_BLOCK:
        raise ValueError(f"{cfg}: {cfg.smem_bytes(size.nw)} B of shared "
                         f"memory > {SMEM_PER_BLOCK}")
    regs, _ = kernel_attrs(cfg, size.nw)   # as compiled
    if regs * cfg.threads > REGS_PER_SM:
        raise ValueError(f"{cfg}: {cfg.threads} threads x {regs} registers "
                         f"> {REGS_PER_SM} on a SM")


def _launch(t: Dict[str, torch.Tensor], cfg: BlockConfig, fused: bool
            ) -> torch.Tensor:
    size = _size(t)
    n_igp, n_ig, n_b = check_tiles(size, cfg)
    _check_launchable(t, cfg, size)
    device = t["wtilde_re"].device
    shape = (n_igp, n_ig, 4, size.nw) if fused else \
        (n_igp, n_ig, n_b, 4, size.nw)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    # the Pallas launcher's layouts: aqsn and wx transposed; aqsm transposed
    # from v7 on, read in place (ngpown, nbands) by v6
    aqsn_re, aqsn_im = t["aqsn_re"].T.contiguous(), t["aqsn_im"].T.contiguous()
    if cfg.aqsm_transposed:
        aqsm_re, aqsm_im = t["aqsm_re"].T.contiguous(), t["aqsm_im"].T.contiguous()
    else:
        aqsm_re, aqsm_im = t["aqsm_re"], t["aqsm_im"]
    wx = t["wx"].T.contiguous()
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.gpp_launch(
            int(fused), int(cfg.aqsm_transposed), cfg.ept_instance(), size.nw,
            cfg.threads,
            t["wtilde_re"].data_ptr(), t["wtilde_im"].data_ptr(),
            t["eps_re"].data_ptr(), t["eps_im"].data_ptr(),
            aqsn_re.data_ptr(), aqsn_im.data_ptr(),
            aqsm_re.data_ptr(), aqsm_im.data_ptr(),
            wx.data_ptr(), t["vcoul"].data_ptr(), out.data_ptr(),
            size.ncouls, size.ngpown, size.nbands,
            cfg.blk_ig, cfg.blk_igp, cfg.blk_band,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gpp {'fused' if fused else 'banded'} launch "
                           f"failed with CUDA error {rc} for {cfg}")
    return out


def gpp_fused(t: Dict[str, torch.Tensor], cfg: BlockConfig) -> torch.Tensor:
    """v9/v10 partials (n_igp, n_ig, 4, nw): the CUDA kernel for CUDA
    tensors (raises if it cannot launch), the plain version for CPU ones."""
    if t["wtilde_re"].device.type == "cpu":
        return gpp_fused_plain(t, cfg)
    out = _launch(t, cfg, fused=True)
    gpp_fused.launches += 1
    return out


def gpp_banded(t: Dict[str, torch.Tensor], cfg: BlockConfig) -> torch.Tensor:
    """v6–v8 partials (n_igp, n_ig, n_b, 4, nw): the CUDA kernel for CUDA
    tensors (raises if it cannot launch), the plain version for CPU ones."""
    if t["wtilde_re"].device.type == "cpu":
        return gpp_banded_plain(t, cfg)
    out = _launch(t, cfg, fused=False)
    gpp_banded.launches += 1
    return out


gpp_fused.launches = 0
gpp_banded.launches = 0


def kernel_attrs(cfg: BlockConfig, nw: int = 2) -> Tuple[int, int]:
    """(registers a thread, spilled local bytes) of the compiled instance
    `cfg` runs on (card only: builds the library)."""
    regs, local = _I(), _I()
    rc = _lib().gpp_func_attrs(int(cfg.fused_acc), int(cfg.aqsm_transposed),
                               cfg.ept_instance(), nw, ctypes.byref(regs),
                               ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"gpp_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


def launch_shape(size: GppSize, cfg: BlockConfig) -> Tuple[int, int, int]:
    """The library's own (dynamic shared memory, static shared memory,
    blocks) of a launch of `cfg` at `size`, from the helpers gpp_launch
    itself takes them from; launches nothing (card only: builds the
    library)."""
    out = [ctypes.c_longlong() for _ in range(3)]
    rc = _lib().gpp_launch_shape(
        int(cfg.fused_acc), int(cfg.aqsm_transposed), cfg.ept_instance(),
        size.nw, size.ncouls, size.ngpown, size.nbands, cfg.blk_ig,
        cfg.blk_igp, cfg.blk_band, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"gpp_launch_shape failed with CUDA error {rc} "
                           f"for {cfg} at {size}")
    return tuple(x.value for x in out)


def gpp_cuda(t: Dict[str, torch.Tensor], cfg: BlockConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the blocked GPP kernel under `cfg` on the planar tensors `t`
    (problem.to_tensors) and sum its partials. Returns (ach (nw,)
    complex64, asx (nw,) complex64) on the tensors' device."""
    if cfg.fused_acc:
        sums = gpp_fused(t, cfg).sum((0, 1))
    else:
        sums = gpp_banded(t, cfg).sum((0, 1, 2))
    sums = sums.to(torch.float32)
    return torch.complex(sums[0], sums[1]), torch.complex(sums[2], sums[3])


def hbm_traffic_model(size: GppSize, cfg: BlockConfig) -> float:
    """Bytes the kernels read from device memory under `cfg`, counting
    each block's own loads (L2 hits counted as misses):
      wtilde/eps: once per (igp, ig) tile — per band block when banded
      aqsn: per igp tile; aqsm: per ig tile; wx: per block
      vcoul and the partials: once per block.
    """
    n_igp, n_ig, n_b = check_tiles(size, cfg)
    wt_reads = 1 if cfg.fused_acc else n_b
    blocks = n_igp * n_ig * (1 if cfg.fused_acc else n_b)
    b = 0.0
    b += wt_reads * 4 * 4 * size.ncouls * size.ngpown       # wt/eps planes
    b += n_igp * 2 * 4 * size.ncouls * size.nbands          # aqsn
    b += n_ig * 2 * 4 * size.ngpown * size.nbands           # aqsm
    b += n_igp * n_ig * 4 * size.nw * size.nbands           # wx
    b += wt_reads * n_igp * 4 * size.ncouls                 # vcoul
    b += blocks * 4 * 4 * size.nw                           # partials
    return b



def grid_blocks(size: GppSize, cfg: BlockConfig) -> int:
    n_igp, n_ig, n_b = check_tiles(size, cfg)
    return n_igp * n_ig * (1 if cfg.fused_acc else n_b)
