"""Paged decode attention for Hopper: the wrappers of the three entry
points of `repro_torch/csrc/paged_decode.cu`, each with its launch
counter, beside their plain versions (kernels/paged/paged.py).

    out = paged_decode_gather(q, kpool, vpool, table, cache_len, ppb)
    out = paged_decode_int8(q, kpool, vpool, table, cache_len, kscale,
                            vscale, ppb)
    out = paged_decode_verify(q, kpool, vpool, table, cache_len, ppb,
                              kscale=None, vscale=None)

Each replaces one pure-JAX version of `repro.kernels.paged.paged`:
`paged_decode_gather` (:123), `paged_decode_int8` (:222) and
`paged_decode_verify` (:182). q (B, H, Hd) bf16 for gather and int8,
(B, Q, H, Hd) or (B, H, Hd) for verify; pools (P, page, KvH, Hd), bf16
(int8 with (P,) f32 kscale/vscale); table (B, npt) int32; cache_len (B,)
int32; out in q's shape, bf16. ppb is `PagedBlockConfig.pages_per_block`
and must divide npt.

A CPU q takes the plain version; a CUDA q launches the kernel, and every
other tensor must then be on the card, contiguous and of the kernel's
type, with Hd a multiple of 16 and the block's shared memory within one
CTA's (`smem_bytes`), or the wrapper raises. One CTA of 128 threads per
(kv head, row); the design and what bounds it are in the source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged import paged

SMEM_PER_BLOCK = 232_448           # Hopper opt-in dynamic shared memory
ROW_PAD = 16                       # bytes after each staged K/V line
ROWS_AT_ONCE = 8                   # query rows a thread holds (RC)


def smem_bytes(rows: int, hd: int, span: int, ppb: int, kv_bytes: int) -> int:
    """Dynamic shared memory of one launch (csrc/paged_decode.cu's
    smem_bytes): rows = G x Q query rows, span = ppb x page lines. f32 q
    and scores over the rows rounded up to 8, acc, m/l/corr, the block's
    page scales and ids (rounded up to 16 bytes), then K and V lines of
    hd x kv_bytes + 16 bytes."""
    rp = -(-rows // ROWS_AT_ONCE) * ROWS_AT_ONCE
    floats = rp * hd + rows * hd + rp * span + 3 * rows + 3 * ppb
    return -(-floats * 4 // 16) * 16 + 2 * span * (hd * kv_bytes + ROW_PAD)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare paged_decode.cu's C interface on a loaded library."""
    lib.paged_gather_run.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
    lib.paged_gather_run.restype = _I
    lib.paged_int8_run.argtypes = [_P] * 8 + [_I] * 8 + [_F, _P]
    lib.paged_int8_run.restype = _I
    lib.paged_verify_run.argtypes = [_I] + [_P] * 8 + [_I] * 9 + [_F, _P]
    lib.paged_verify_run.restype = _I
    lib.paged_smem_bytes.argtypes = [_I] * 5
    lib.paged_smem_bytes.restype = ctypes.c_longlong
    lib.paged_func_attrs.argtypes = [_I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)]
    lib.paged_func_attrs.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("paged_decode.cu"))


def _shape(q, kpool, vpool, table, cache_len) -> Tuple[int, ...]:
    """(B, Q, H, KvH, Hd, P, page, npt) of a call; raises on shapes that
    do not agree."""
    if q.dim() not in (3, 4) or kpool.dim() != 4:
        raise ValueError(f"q must be (B, H, Hd) or (B, Q, H, Hd) and the "
                         f"pools (P, page, KvH, Hd): {tuple(q.shape)}, "
                         f"{tuple(kpool.shape)}")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    qn = q.shape[1] if q.dim() == 4 else 1
    n_pages, page, kvh, pool_hd = kpool.shape
    if (tuple(vpool.shape) != tuple(kpool.shape) or pool_hd != hd
            or h % kvh or table.dim() != 2 or table.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, kpool "
            f"{tuple(kpool.shape)}, vpool {tuple(vpool.shape)}, table "
            f"{tuple(table.shape)}, cache_len {tuple(cache_len.shape)}")
    return b, qn, h, kvh, hd, n_pages, page, table.shape[1]


def _check_launchable(q, kpool, vpool, table, cache_len, kscale, vscale,
                      ppb: int, int8: bool) -> Tuple[int, ...]:
    dims = _shape(q, kpool, vpool, table, cache_len)
    b, qn, h, kvh, hd, n_pages, page, npt = dims
    named = [("q", q), ("kpool", kpool), ("vpool", vpool),
             ("block_table", table), ("cache_len", cache_len)]
    if int8:
        if kscale is None or vscale is None:
            raise ValueError("an int8 pool needs kscale/vscale")
        named += [("kscale", kscale), ("vscale", vscale)]
    pool_dtype = torch.int8 if int8 else torch.bfloat16
    want = {"q": torch.bfloat16, "kpool": pool_dtype, "vpool": pool_dtype,
            "block_table": torch.int32, "cache_len": torch.int32,
            "kscale": torch.float32, "vscale": torch.float32}
    for name, x in named:
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}, the kernel needs "
                             "every tensor on the card")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != want[name]:
            raise ValueError(f"{name} is {x.dtype}, the kernel takes "
                             f"{want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous (strides "
                             f"{x.stride()})")
    if int8 and (tuple(kscale.shape) != (n_pages,)
                 or tuple(vscale.shape) != (n_pages,)):
        raise ValueError(f"kscale/vscale must be ({n_pages},): "
                         f"{tuple(kscale.shape)}, {tuple(vscale.shape)}")
    if hd % 16:
        raise ValueError(f"head dim {hd} is not a multiple of 16")
    for name, x in (("kpool", kpool), ("vpool", vpool)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    if ppb <= 0 or npt % ppb:
        raise ValueError(f"pages_per_block {ppb} does not tile npt={npt}")
    need = smem_bytes((h // kvh) * qn, hd, ppb * page, ppb, 1 if int8 else 2)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"pages_per_block {ppb}: {need} B of shared memory "
                         f"> {SMEM_PER_BLOCK}")
    return dims


def _run(entry: str, q, kpool, vpool, table, cache_len, kscale, vscale,
         ppb: int, int8: bool) -> torch.Tensor:
    b, qn, h, kvh, hd, n_pages, page, npt = _check_launchable(
        q, kpool, vpool, table, cache_len, kscale, vscale, ppb, int8)
    out = torch.empty_like(q)
    scale = float(hd ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (b, h, kvh, hd, n_pages, page, npt, ppb, scale, stream)
    with torch.cuda.device(q.device):
        lib = _lib()
        if entry == "gather":
            rc = lib.paged_gather_run(q.data_ptr(), kpool.data_ptr(),
                                      vpool.data_ptr(), table.data_ptr(),
                                      cache_len.data_ptr(), out.data_ptr(),
                                      *tail)
        elif entry == "int8":
            rc = lib.paged_int8_run(q.data_ptr(), kpool.data_ptr(),
                                    vpool.data_ptr(), kscale.data_ptr(),
                                    vscale.data_ptr(), table.data_ptr(),
                                    cache_len.data_ptr(), out.data_ptr(),
                                    *tail)
        else:
            rc = lib.paged_verify_run(
                int(int8), q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                kscale.data_ptr() if int8 else None,
                vscale.data_ptr() if int8 else None, table.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), b, qn, *tail[1:])
    if rc != 0:
        raise RuntimeError(f"paged_decode {entry} launch failed with CUDA "
                           f"error {rc} at q {tuple(q.shape)}, pool "
                           f"{tuple(kpool.shape)}, pages_per_block {ppb}")
    return out


def paged_decode_gather(q: torch.Tensor, kpool: torch.Tensor,
                        vpool: torch.Tensor, block_table: torch.Tensor,
                        cache_len: torch.Tensor, ppb: int) -> torch.Tensor:
    """One query a row (q (B,H,Hd)) over a bf16 pool: the kernel for a
    CUDA q (raises if it cannot launch), the plain version for a CPU one.
    Replaces repro/kernels/paged/paged.py:123 paged_decode_gather."""
    if q.device.type == "cpu":
        return paged.paged_decode_gather(q, kpool, vpool, block_table,
                                         cache_len, pages_per_block=ppb)
    if q.dim() != 3:
        raise ValueError(f"gather takes q (B, H, Hd): {tuple(q.shape)}")
    out = _run("gather", q, kpool, vpool, block_table, cache_len, None,
               None, ppb, False)
    paged_decode_gather.launches += 1
    return out


def paged_decode_int8(q: torch.Tensor, kpool: torch.Tensor,
                      vpool: torch.Tensor, block_table: torch.Tensor,
                      cache_len: torch.Tensor, kscale: torch.Tensor,
                      vscale: torch.Tensor, ppb: int) -> torch.Tensor:
    """One query a row over an int8 pool with (P,) f32 scales.
    Replaces repro/kernels/paged/paged.py:222 paged_decode_int8."""
    if q.device.type == "cpu":
        return paged.paged_decode_int8(q, kpool, vpool, block_table,
                                       cache_len, kscale, vscale,
                                       pages_per_block=ppb)
    if q.dim() != 3:
        raise ValueError(f"int8 takes q (B, H, Hd): {tuple(q.shape)}")
    out = _run("int8", q, kpool, vpool, block_table, cache_len, kscale,
               vscale, ppb, True)
    paged_decode_int8.launches += 1
    return out


def paged_decode_verify(q: torch.Tensor, kpool: torch.Tensor,
                        vpool: torch.Tensor, block_table: torch.Tensor,
                        cache_len: torch.Tensor, ppb: int,
                        kscale: Optional[torch.Tensor] = None,
                        vscale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Q queries a row (q (B,Q,H,Hd), or (B,H,Hd) for Q = 1) over a bf16
    pool, or an int8 pool with kscale/vscale. Replaces
    repro/kernels/paged/paged.py:182 paged_decode_verify."""
    if q.device.type == "cpu":
        return paged.paged_decode_verify(q, kpool, vpool, block_table,
                                         cache_len, pages_per_block=ppb,
                                         kscale=kscale, vscale=vscale)
    out = _run("verify", q, kpool, vpool, block_table, cache_len, kscale,
               vscale, ppb, kpool.dtype == torch.int8)
    paged_decode_verify.launches += 1
    return out


paged_decode_gather.launches = 0
paged_decode_int8.launches = 0
paged_decode_verify.launches = 0

ENTRY_POINTS = (paged_decode_gather, paged_decode_int8, paged_decode_verify)


def kernel_attrs(int8: bool) -> Tuple[int, int]:
    """(registers a thread, spilled local bytes) of the bf16 or int8
    instance (card only: builds the library)."""
    regs, local = _I(), _I()
    rc = _lib().paged_func_attrs(int(int8), ctypes.byref(regs),
                                 ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"paged_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


def library_smem_bytes(rows: int, hd: int, span: int, ppb: int,
                       kv_bytes: int) -> int:
    """The library's own count of a launch's shared memory (card only),
    to hold `smem_bytes` to it."""
    return int(_lib().paged_smem_bytes(rows, hd, span, ppb, kv_bytes))
