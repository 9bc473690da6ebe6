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

The kernel splits each row's pages over `splits` CTAs (flash-decoding):
the grid is (splits, KvH, B x row groups), a CTA of 4 warps streams its
split's pages through a ring of up to 3 stages of min(ppb, ceil(npt /
splits)) pages (16-byte cp.async, one commit group and one barrier a
stage), scores and sums on the tensor cores (mma.sync; p as three bf16
parts, so the value product takes the f32 p), and writes a
partial (m, l, acc) that a second small kernel, launched as its
programmatic dependent, merges in split order (none at splits = 1). The
wrapper allocates the partials' scratch with torch.empty and sets the
split count by `split_count` (about two CTAs an SM: 16 at qwen2-1.5b's
decode and at B=8), or takes `splits=`. What bounds it: the loads at a
long context (B=8 x 8,192: 67 MB, a 20 us bound; the ring streams ~2
TB/s), the widening of int8 lines there, latency at qwen2's decode, whose
4.19 MB stay in L2 between calls; the rest is in the source.

Shared memory (`plan`, csrc/paged_decode.cu's plan()): the q tile of 16
x MT rows (MT = 1 up to 16 query rows a kv head, 2 up to 32; more rows
take more row groups) at 2 Hd + 16 bytes a row, the split's page ids (and
int8 scales), for an int8 pool each warp's bf16 copy of a 16-line chunk,
then the ring of `stages` stages of 2 x lines x (Hd x itemsize + 16)
bytes, overlaid at the end by the warps' f32 merge rows.

A CPU q takes the plain version (at `splits`, 1 by default: the
reference's order); a CUDA q launches the kernel, and every other tensor
must then be on the card, contiguous and of the kernel's type, with Hd
32, 64 or 128 (every config's head dim, reduce_config's 32 included) and
one stage within one CTA's shared memory, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged import paged

SMEM_PER_BLOCK = 232_448           # Hopper opt-in dynamic shared memory
ROW_PAD = 16                       # bytes after each staged row
WARPS = 4                          # warps a CTA
CHUNK = 16                         # lines a warp takes at once
MAX_STAGES = 3                     # ring depth at most
MAX_SPLITS = 16
CTAS_PER_SM = 2                    # the grid the split count aims at
HEAD_DIMS = (32, 64, 128)          # compiled instances


def row_tiles(rows: int) -> Tuple[int, int]:
    """(MT, row groups): 16-row tiles a CTA holds, and CTAs a (row, kv
    head) takes for `rows` = G x Q query rows."""
    mt = 1 if rows <= 16 else 2
    return mt, -(-rows // (16 * mt))


def split_count(b: int, kvh: int, rows: int, npt: int, sms: int) -> int:
    """The wrapper's split count: the largest power of two, at most
    MAX_SPLITS and npt, that keeps the grid within CTAS_PER_SM CTAs an SM
    (8 (row, kv head) pairs on 132 SMs: 16; 16 pairs: 16)."""
    pairs = b * kvh * row_tiles(rows)[1]
    want = max(1, CTAS_PER_SM * sms // pairs)
    s = 1
    while 2 * s <= min(want, MAX_SPLITS, npt):
        s *= 2
    return s


def plan(rows: int, hd: int, page: int, npt: int, ppb: int, splits: int,
         kv_bytes: int) -> dict:
    """A launch's shape, as csrc/paged_decode.cu's plan(): pages a stage
    (sp), lines a stage slot, ring stages (0: one stage does not fit), the
    cp.async K/V ring's bytes and the dynamic shared memory in bytes."""
    mt, _ = row_tiles(rows)
    maxp = -(-npt // splits)
    sp = min(ppb, maxp)
    lines = -(-sp * page // CHUNK) * CHUNK
    need = -(-maxp // sp)
    qrow = 2 * hd + ROW_PAD
    stage = 2 * lines * (hd * kv_bytes + ROW_PAD)
    fixed = (16 * mt * qrow
             + -(-maxp * 4 * (3 if kv_bytes == 1 else 1) // 16) * 16
             + (WARPS * 2 * CHUNK * qrow if kv_bytes == 1 else 0))
    merge = WARPS * 16 * mt * (hd + 2) * 4
    stages = next((n for n in range(min(MAX_STAGES, need), 0, -1)
                   if fixed + max(n * stage, merge) <= SMEM_PER_BLOCK), 0)
    return {"pages_a_stage": sp, "lines": lines, "stages": stages,
            "ring_bytes": stages * stage,
            "smem": fixed + max(max(stages, 1) * stage, merge)}


def grid_blocks(b: int, kvh: int, rows: int, splits: int) -> int:
    """Blocks of the split kernel's grid (splits, KvH, B x row groups)."""
    return splits * kvh * b * row_tiles(rows)[1]


def smem_bytes(rows: int, hd: int, page: int, npt: int, ppb: int,
               splits: int, kv_bytes: int) -> int:
    """Dynamic shared memory of one launch (`plan`'s); above
    SMEM_PER_BLOCK when not even one stage fits."""
    return plan(rows, hd, page, npt, ppb, splits, kv_bytes)["smem"]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(_I)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare paged_decode.cu's C interface on a loaded library."""
    lib.paged_gather_run.argtypes = [_P] * 7 + [_I] * 9 + [_F, _P]
    lib.paged_gather_run.restype = _I
    lib.paged_int8_run.argtypes = [_P] * 9 + [_I] * 9 + [_F, _P]
    lib.paged_int8_run.restype = _I
    lib.paged_verify_run.argtypes = [_I] + [_P] * 9 + [_I] * 10 + [_F, _P]
    lib.paged_verify_run.restype = _I
    lib.paged_smem_bytes.argtypes = [_I] * 7 + [_IP]
    lib.paged_smem_bytes.restype = ctypes.c_longlong
    lib.paged_func_attrs.argtypes = [_I] * 3 + [_IP, _IP]
    lib.paged_func_attrs.restype = _I
    lib.paged_occupancy.argtypes = [_I] * 7 + [_IP]
    lib.paged_occupancy.restype = _I
    lib.paged_launch_shape.argtypes = ([_I] * 9
                                       + [ctypes.POINTER(ctypes.c_longlong)] * 3)
    lib.paged_launch_shape.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load("paged_decode.cu"))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def card_sms() -> int:
    """SMs of the current card (card only)."""
    return _sms(torch.cuda.current_device())


def splits_for(q, kpool, table) -> int:
    """The split count the kernel takes for these tensors (CUDA q)."""
    b, h, qn = q.shape[0], q.shape[-2], q.shape[1] if q.dim() == 4 else 1
    kvh = kpool.shape[2]
    return split_count(b, kvh, h // kvh * qn, table.shape[1],
                       _sms(q.device.index or 0))


def _check_launchable(q, kpool, vpool, table, cache_len, kscale, vscale,
                      ppb: int, splits: int, int8: bool) -> Tuple[int, ...]:
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    for name, x in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")
    if ppb <= 0 or npt % ppb:
        raise ValueError(f"pages_per_block {ppb} does not tile npt={npt}")
    if splits <= 0:
        raise ValueError(f"splits {splits} must be positive")
    shape = plan((h // kvh) * qn, hd, page, npt, ppb, splits,
                 1 if int8 else 2)
    if shape["stages"] == 0:
        raise ValueError(f"pages_per_block {ppb}: {shape['smem']} B of "
                         f"shared memory > {SMEM_PER_BLOCK}")
    return dims


def _run(entry: str, q, kpool, vpool, table, cache_len, kscale, vscale,
         ppb: int, splits: Optional[int], int8: bool) -> torch.Tensor:
    if splits is None:
        splits = splits_for(q, kpool, table)
    b, qn, h, kvh, hd, n_pages, page, npt = _check_launchable(
        q, kpool, vpool, table, cache_len, kscale, vscale, ppb, splits, int8)
    out = torch.empty_like(q)
    rows = (h // kvh) * qn
    part = (torch.empty(b * kvh * splits * rows * (hd + 2),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    part_ptr = None if part is None else part.data_ptr()
    scale = float(hd ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (b, h, kvh, hd, n_pages, page, npt, ppb, splits, scale, stream)
    with torch.cuda.device(q.device):
        lib = _lib()
        if entry == "gather":
            rc = lib.paged_gather_run(q.data_ptr(), kpool.data_ptr(),
                                      vpool.data_ptr(), table.data_ptr(),
                                      cache_len.data_ptr(), out.data_ptr(),
                                      part_ptr, *tail)
        elif entry == "int8":
            rc = lib.paged_int8_run(q.data_ptr(), kpool.data_ptr(),
                                    vpool.data_ptr(), kscale.data_ptr(),
                                    vscale.data_ptr(), table.data_ptr(),
                                    cache_len.data_ptr(), out.data_ptr(),
                                    part_ptr, *tail)
        else:
            rc = lib.paged_verify_run(
                int(int8), q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
                kscale.data_ptr() if int8 else None,
                vscale.data_ptr() if int8 else None, table.data_ptr(),
                cache_len.data_ptr(), out.data_ptr(), part_ptr, b, qn,
                *tail[1:])
    if rc != 0:
        raise RuntimeError(f"paged_decode {entry} launch failed with CUDA "
                           f"error {rc} at q {tuple(q.shape)}, pool "
                           f"{tuple(kpool.shape)}, pages_per_block {ppb}, "
                           f"splits {splits}")
    return out


def paged_decode_gather(q: torch.Tensor, kpool: torch.Tensor,
                        vpool: torch.Tensor, block_table: torch.Tensor,
                        cache_len: torch.Tensor, ppb: int,
                        splits: Optional[int] = None) -> torch.Tensor:
    """One query a row (q (B,H,Hd)) over a bf16 pool: the kernel for a
    CUDA q (raises if it cannot launch), the plain version for a CPU one.
    Replaces repro/kernels/paged/paged.py:123 paged_decode_gather."""
    if q.device.type == "cpu":
        return paged.paged_decode_gather(q, kpool, vpool, block_table,
                                         cache_len, pages_per_block=ppb,
                                         splits=splits or 1)
    if q.dim() != 3:
        raise ValueError(f"gather takes q (B, H, Hd): {tuple(q.shape)}")
    out = _run("gather", q, kpool, vpool, block_table, cache_len, None,
               None, ppb, splits, False)
    paged_decode_gather.launches += 1
    return out


def paged_decode_int8(q: torch.Tensor, kpool: torch.Tensor,
                      vpool: torch.Tensor, block_table: torch.Tensor,
                      cache_len: torch.Tensor, kscale: torch.Tensor,
                      vscale: torch.Tensor, ppb: int,
                      splits: Optional[int] = None) -> torch.Tensor:
    """One query a row over an int8 pool with (P,) f32 scales.
    Replaces repro/kernels/paged/paged.py:222 paged_decode_int8."""
    if q.device.type == "cpu":
        return paged.paged_decode_int8(q, kpool, vpool, block_table,
                                       cache_len, kscale, vscale,
                                       pages_per_block=ppb,
                                       splits=splits or 1)
    if q.dim() != 3:
        raise ValueError(f"int8 takes q (B, H, Hd): {tuple(q.shape)}")
    out = _run("int8", q, kpool, vpool, block_table, cache_len, kscale,
               vscale, ppb, splits, True)
    paged_decode_int8.launches += 1
    return out


def paged_decode_verify(q: torch.Tensor, kpool: torch.Tensor,
                        vpool: torch.Tensor, block_table: torch.Tensor,
                        cache_len: torch.Tensor, ppb: int,
                        kscale: Optional[torch.Tensor] = None,
                        vscale: Optional[torch.Tensor] = None,
                        splits: Optional[int] = None) -> torch.Tensor:
    """Q queries a row (q (B,Q,H,Hd), or (B,H,Hd) for Q = 1) over a bf16
    pool, or an int8 pool with kscale/vscale. Replaces
    repro/kernels/paged/paged.py:182 paged_decode_verify."""
    if q.device.type == "cpu":
        return paged.paged_decode_verify(q, kpool, vpool, block_table,
                                         cache_len, pages_per_block=ppb,
                                         kscale=kscale, vscale=vscale,
                                         splits=splits or 1)
    out = _run("verify", q, kpool, vpool, block_table, cache_len, kscale,
               vscale, ppb, splits, kpool.dtype == torch.int8)
    paged_decode_verify.launches += 1
    return out


paged_decode_gather.launches = 0
paged_decode_int8.launches = 0
paged_decode_verify.launches = 0

ENTRY_POINTS = (paged_decode_gather, paged_decode_int8, paged_decode_verify)


def kernel_attrs(int8: bool, hd: int = 128, tiles: int = 1
                 ) -> Tuple[int, int]:
    """(registers a thread, spilled local bytes) of the split kernel's
    instance for an int8 or bf16 pool, head dim hd and `tiles` 16-row
    query tiles; tiles 0 is the combine kernel (card only: builds the
    library)."""
    regs, local = _I(), _I()
    rc = _lib().paged_func_attrs(int(int8), hd, tiles, ctypes.byref(regs),
                                 ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"paged_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


def library_smem_bytes(rows: int, hd: int, page: int, npt: int, ppb: int,
                       splits: int, kv_bytes: int) -> Tuple[int, int]:
    """The library's own (shared memory, stages) of a launch (card only),
    to hold `plan` to it."""
    stages = _I()
    smem = _lib().paged_smem_bytes(rows, hd, page, npt, ppb, splits,
                                   kv_bytes, ctypes.byref(stages))
    return int(smem), stages.value


def launch_shape(int8: bool, b: int, kvh: int, rows: int, hd: int, page: int,
                 npt: int, ppb: int, splits: int) -> Tuple[int, int, int]:
    """The library's own (dynamic shared memory, static shared memory,
    blocks) of the split kernel's launch; launches nothing (card only:
    builds the library)."""
    out = [ctypes.c_longlong() for _ in range(3)]
    rc = _lib().paged_launch_shape(int(int8), rows, hd, page, npt, ppb,
                                   splits, kvh, b,
                                   *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"paged_launch_shape failed with CUDA error {rc} "
                           f"at rows {rows}, hd {hd}, ppb {ppb}, splits "
                           f"{splits}")
    return tuple(x.value for x in out)


def occupancy(int8: bool, rows: int, hd: int, page: int, npt: int, ppb: int,
              splits: int) -> int:
    """CTAs of such a launch one SM holds at once (card only)."""
    blocks = _I()
    rc = _lib().paged_occupancy(int(int8), rows, hd, page, npt, ppb, splits,
                                ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"paged_occupancy failed with CUDA error {rc}")
    return blocks.value
