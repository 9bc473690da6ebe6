"""Selective scan for Hopper — the port of `repro.kernels.ssm.ssm_scan`
(`_kernel` :30 under `ssm_scan_pallas` :64): the hand-written CUDA kernel
(`repro_torch/csrc/ssm_scan.cu`), its launcher and launch counter, its
plain-torch version, the kernel's I/O bytes (`kernel_hbm_bytes`, :89), the
Hopper shared-memory size that replaces `vmem_bytes`, and the SASS census
of its step loop (`census`).

    y, hT = ssm_scan(x, dt, bmat, cmat, a_log, d, h0, cfg)

x, dt: (B, T, C) f32; bmat, cmat: (B, T, N) f32; a_log: (C, N) and d:
(C,), f32 or bf16 (the model's params are bf16; the kernel reads them as
f32, as the Pallas kernel does); h0: (B, C, N) f32. Per step
h <- exp(dt a) h + (dt x) b^T and y_t = h c_t + d x_t with a = -exp(a_log).
Returns y (B, T, C) f32 and hT (B, C, N) f32. A CUDA tensor launches the
kernel (N in {4, 8, 16}, every tensor contiguous, bmat and cmat on
16-byte boundaries, C a multiple of cfg.blk_c) or raises; a CPU tensor
takes `ssm_scan_plain`.

The kernel gives a thread `states` consecutive states of one channel: it
loads (x, dt) and computes dt x once for them, reads their b and c as two
vector loads and sums h c over them as an FMA chain; the channel's N /
states lanes add their partial sums in a transposing shuffle butterfly
every 16 steps (32 at two states). A CTA of blk_c channels stages TIME_TILE steps at a time
in a ring of STAGES tiles: b and c as one bulk copy each (mbarrier), x and
dt as 16-byte cp.async rows. Grid (C / blk_c, B).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models import mamba

N_INSTANCES = (4, 8, 16)           # state sizes compiled in ssm_scan.cu
STATE_INSTANCES = (2, 4, 8)        # states a thread compiled (<= N)
TIME_TILE = 64                     # steps a staged tile holds (ssm_scan.cu)
STAGES = 3                         # tiles in the shared-memory ring
MAX_THREADS = 256                  # the kernel's __launch_bounds__
SMEM_PER_BLOCK = 232_448           # Hopper opt-in dynamic shared memory
BC_ALIGN = 16                      # bytes: bmat/cmat are bulk-copied


@dataclasses.dataclass(frozen=True)
class SsmScanConfig:
    """blk_c channels a CTA, `states` consecutive states a thread: N /
    states lanes a channel, blk_c x N / states threads (rounded up to
    whole warps). The TPU's 128-channel slab with the whole time axis in
    VMEM becomes 8 channels x 8 lanes over a 64-step shared-memory ring
    (the model's pick at hymba-1.5b's prefill). A tune-cache entry that
    holds only blk_c (the kernel before states existed) loads with the
    default states."""
    name: str = "ssm"
    blk_c: int = 8
    states: int = 2

    def clamped(self, key) -> "SsmScanConfig":
        return dataclasses.replace(self, blk_c=div_clamp(self.blk_c, key.c),
                                   states=min(self.states, key.n))

    def lanes(self, n: int) -> int:
        return n // self.states

    def threads(self, n: int) -> int:
        return -(-self.blk_c * self.lanes(n) // 32) * 32

    def smem_bytes(self, n: int) -> int:
        """STAGES tiles of x and dt (TIME_TILE x blk_c) and of b and c
        (TIME_TILE x N), f32, and one 8-byte mbarrier a stage."""
        return STAGES * (TIME_TILE * (2 * self.blk_c + 2 * n) * 4 + 8)


def div_clamp(blk: int, c: int) -> int:
    """Largest block <= blk that exactly tiles c (a plain min() clamp on
    e.g. c=130 would leave channels uncomputed)."""
    blk = min(blk, c)
    while c % blk:
        blk -= 1
    return blk


def kernel_hbm_bytes(b: int, t: int, c: int, n: int) -> float:
    """The kernel's I/O, every operand f32: x/dt in, y out, b/c, h0/hT,
    a_log and d."""
    return float((3 * b * t * c + 2 * b * t * n + 2 * b * c * n
                  + c * n + c) * 4)


def useful_flops(b: int, t: int, c: int, n: int) -> float:
    """FP32 operations of the scan on these shapes: per (t, c, n) dt*a,
    its exp (counted as one), (dt x)*b, the state FMA (2) and h*c with its
    sum over N (2); per (t, c) dt*x and d*x + the sum (3)."""
    return float(b * t * c * (7 * n + 3))


def _check_shapes(x, dt, bmat, cmat, a_log, d, h0) -> Tuple[int, int, int, int]:
    if x.dim() != 3 or a_log.dim() != 2:
        raise ValueError(f"x must be (B, T, C) and a_log (C, N): "
                         f"{tuple(x.shape)}, {tuple(a_log.shape)}")
    b, t, c = x.shape
    n = a_log.shape[1]
    want = {"dt": (b, t, c), "bmat": (b, t, n), "cmat": (b, t, n),
            "a_log": (c, n), "d": (c,), "h0": (b, c, n)}
    for name, x_ in (("dt", dt), ("bmat", bmat), ("cmat", cmat),
                     ("a_log", a_log), ("d", d), ("h0", h0)):
        if tuple(x_.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(x_.shape)}, want "
                             f"{want[name]} for x {tuple(x.shape)}")
        if x_.device != x.device:
            raise ValueError(f"{name} is on {x_.device}, x on {x.device}")
    return b, t, c, n


# ---------------------------------------------------------------------------
# plain version (torch)
# ---------------------------------------------------------------------------

def ssm_scan_plain(x, dt, bmat, cmat, a_log, d, h0,
                   cfg: SsmScanConfig = SsmScanConfig(),
                   dtype: torch.dtype = torch.float32):
    """The kernel's function in torch: the sequential recurrence of
    models.mamba.ssm_scan (the oracle), on any device, computed in `dtype`
    (float32, the kernel's; float64 for the distance of both from exact
    arithmetic on the same inputs). cfg only selects the kernel's
    blocking, which does not change the function. Returns (y (B,T,C),
    hT (B,C,N)) in `dtype`."""
    _check_shapes(x, dt, bmat, cmat, a_log, d, h0)
    return mamba.ssm_scan(x, dt, bmat, cmat, a_log, d, h0, dtype=dtype)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ssm_scan.cu's C interface on a loaded library."""
    lib.ssm_scan_run.argtypes = [_I] * 4 + [_P] * 9 + [_I] * 4 + [_P]
    lib.ssm_scan_run.restype = _I
    lib.ssm_func_attrs.argtypes = [_I, _I, _I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_I)]
    lib.ssm_func_attrs.restype = _I
    lib.ssm_launch_shape.argtypes = ([_I] * 6
                                     + [ctypes.POINTER(ctypes.c_longlong)] * 3)
    lib.ssm_launch_shape.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("ssm_scan.cu"))


def _check_launchable(x, dt, bmat, cmat, a_log, d, h0, cfg: SsmScanConfig,
                      c: int, n: int) -> None:
    for name, x_ in (("x", x), ("dt", dt), ("bmat", bmat), ("cmat", cmat),
                     ("h0", h0), ("a_log", a_log), ("d", d)):
        if x_.device.type != "cuda":
            raise ValueError(f"{name} is on {x_.device}, the kernel needs CUDA")
        if not x_.is_contiguous():
            raise ValueError(f"{name} is not contiguous (strides "
                             f"{x_.stride()})")
        if name in ("a_log", "d"):
            if x_.dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"{name} is {x_.dtype}, the kernel takes "
                                 "float32 or bfloat16")
        elif x_.dtype != torch.float32:
            raise ValueError(f"{name} is {x_.dtype}, the kernel takes float32")
    if a_log.dtype != d.dtype:
        raise ValueError(f"a_log is {a_log.dtype}, d {d.dtype}: one dtype")
    for name, x_ in (("bmat", bmat), ("cmat", cmat)):
        if x_.data_ptr() % BC_ALIGN:
            raise ValueError(f"{name} does not start on a {BC_ALIGN}-byte "
                             "boundary (the kernel bulk-copies it)")
    if n not in N_INSTANCES:
        raise ValueError(f"state size {n} not compiled (have {N_INSTANCES})")
    if cfg.states not in STATE_INSTANCES or n % cfg.states:
        raise ValueError(f"{cfg}: states must be one of {STATE_INSTANCES} "
                         f"and divide N={n}")
    if cfg.blk_c <= 0 or c % cfg.blk_c:
        raise ValueError(f"{cfg}: blk_c does not tile C={c}")
    if cfg.threads(n) > MAX_THREADS:
        raise ValueError(f"{cfg}: {cfg.threads(n)} threads > {MAX_THREADS}")
    if cfg.smem_bytes(n) > SMEM_PER_BLOCK:
        raise ValueError(f"{cfg}: {cfg.smem_bytes(n)} B of shared memory > "
                         f"{SMEM_PER_BLOCK}")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, a_log: torch.Tensor, d: torch.Tensor,
             h0: torch.Tensor, cfg: SsmScanConfig = SsmScanConfig()
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan: the CUDA kernel for CUDA tensors (raises if it
    cannot launch), the plain version for CPU ones. Returns (y (B,T,C)
    f32, hT (B,C,N) f32)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, bmat, cmat, a_log, d, h0, cfg)
    b, t, c, n = _check_shapes(x, dt, bmat, cmat, a_log, d, h0)
    _check_launchable(x, dt, bmat, cmat, a_log, d, h0, cfg, c, n)
    y = torch.empty((b, t, c), dtype=torch.float32, device=x.device)
    h_t = torch.empty((b, c, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().ssm_scan_run(
            n, cfg.states, int(a_log.dtype == torch.bfloat16), cfg.blk_c,
            x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            a_log.data_ptr(), d.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_t.data_ptr(), b, t, c, TIME_TILE,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed with CUDA error {rc} for "
                           f"{cfg} at x {tuple(x.shape)}, N={n}")
    ssm_scan.launches += 1
    return y, h_t


ssm_scan.launches = 0


def kernel_attrs(n: int, states: int, bf16_params: bool) -> Tuple[int, int]:
    """(registers a thread, spilled local bytes) of the compiled (N,
    states, param dtype) instance (card only: builds the library)."""
    regs, local = _I(), _I()
    rc = _lib().ssm_func_attrs(n, states, int(bf16_params),
                               ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"ssm_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


def launch_shape(b: int, c: int, n: int, cfg: SsmScanConfig,
                 bf16_params: bool = False) -> Tuple[int, int, int]:
    """The library's own (dynamic shared memory, static shared memory,
    blocks) of a launch of `cfg` over b rows of c channels at state size
    n; launches nothing (card only: builds the library)."""
    out = [ctypes.c_longlong() for _ in range(3)]
    rc = _lib().ssm_launch_shape(n, cfg.states, int(bf16_params), cfg.blk_c,
                                 b, c, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"ssm_launch_shape failed with CUDA error {rc} "
                           f"for {cfg} at C={c}, N={n}")
    return tuple(x.value for x in out)


def instances():
    """Every compiled (N, states) pair."""
    return [(n, s) for n in N_INSTANCES for s in STATE_INSTANCES if s <= n]


# ---------------------------------------------------------------------------
# the SASS census of the step loop
# ---------------------------------------------------------------------------

# ssm_scan_kernel<N, S, PT> mangled; the kernel before `states` existed
# (one state a thread) had no S and counts as S = 1
_SYMBOL = r"ssm_scan_kernelILi{n}E(?:Li(\d+)E)?{pt}E"
_PT = {True: "13__nv_bfloat16", False: "f"}


def census(text: str, n: int = 16, bf16_params: bool = True) -> Dict[int, Dict]:
    """{states: core.sass.loop_census} of every compiled ssm_scan_kernel
    instance at state size n and param dtype in the disassembly `text`:
    its innermost loop holding MUFU.EX2, one exp per (t, c, n) element, so
    instructions an element by class, shuffles, the FMA ratio."""
    from repro_torch.core import sass
    pattern = _SYMBOL.format(n=n, pt=_PT[bf16_params])
    out = {}
    for name in sass.functions(text):
        m = re.search(pattern, name)
        if m:
            s = int(m.group(1) or 1)
            out[s] = sass.loop_census(text, re.escape(name), "MUFU.EX2", 1)
    if not out:
        raise ValueError(f"no ssm_scan_kernel<{n}, ...> instance in the SASS")
    return out
