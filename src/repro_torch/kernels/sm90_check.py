"""The shared Hopper helpers of `csrc/sm90.cuh` checked on their own, on
the card (`csrc/sm90_check.cu`; nothing on a model path calls these):

    d = wgmma_product(a, b, mode)      # (64, K) x (K, N) -> (64, N) f32
    tile = tma_rows(x, rows, head, row0, b)

`wgmma_product` runs one warpgroup's product through the header's wgmma
wrappers and descriptors: mode "ss" takes A and B from shared memory with
B K-major, "rs" takes A from registers and B MN-major, "ss-mn" A from
shared memory and B MN-major; both operands are stored 128-byte swizzled.
`tma_rows` loads one TMA box of a (B, S, heads, Hd) bf16 tensor through
the header's tensor map and reads it back through the swizzle. Both
raise without a card; tests/test_torch_sm90_cuda.py and chip_smoke.py
phase 2 hold them against torch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MODES = {"ss": 0, "rs": 1, "ss-mn": 2}
N_SIZES = (32, 64, 128)
K_SIZES = (64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sm90_check.cu")
    lib.sm90_wgmma_check.argtypes = [_I, _I, _I, _P, _P, _P, _I, _I]
    lib.sm90_wgmma_check.restype = _I
    lib.sm90_tma_check.argtypes = [_P] + [_I] * 4 + [_L] * 3 + [_I] * 4 + [_P]
    lib.sm90_tma_check.restype = _I
    return lib


def wgmma_product(a: torch.Tensor, b: torch.Tensor, mode: str,
                  lbo: int = 0, sbo: int = 1024) -> torch.Tensor:
    """a (64, K) @ b (K, N) in f32 through one wgmma chain; a and b bf16 on
    the card, (N, K) in N_SIZES x K_SIZES. lbo/sbo (bytes) describe an
    MN-major B; lbo 0 takes the header's K x 128 (the next 64 columns)."""
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError("wgmma_product runs on the card")
    k, n = b.shape
    if a.shape != (64, k) or n not in N_SIZES or k not in K_SIZES:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)}")
    a = a.to(torch.bfloat16).contiguous()
    bb = (b.t() if mode == "ss" else b).to(torch.bfloat16).contiguous()
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    rc = _lib().sm90_wgmma_check(MODES[mode], n, k, a.data_ptr(),
                                 bb.data_ptr(), d.data_ptr(), lbo or k * 128,
                                 sbo)
    if rc != 0:
        raise RuntimeError(f"sm90_wgmma_check failed with CUDA error {rc}")
    return d


def tma_rows(x: torch.Tensor, rows: int, head: int, row0: int,
             b: int) -> torch.Tensor:
    """x[b, row0:row0 + rows, head, :] (x: (B, S, heads, Hd) bf16 on the
    card, Hd 64 or 128) through one TMA box and the swizzled tile."""
    bsz, s, heads, hd = x.shape
    y = torch.empty((rows, hd), dtype=torch.bfloat16, device=x.device)
    rc = _lib().sm90_tma_check(x.data_ptr(), bsz, s, heads, hd,
                               *x.stride()[:3], rows, head, row0, b,
                               y.data_ptr())
    if rc != 0:
        raise RuntimeError(f"sm90_tma_check failed with CUDA error {rc}")
    return y
