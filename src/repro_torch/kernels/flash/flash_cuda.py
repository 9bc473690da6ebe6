"""Flash-attention forward for Hopper — the port of
`repro.kernels.flash.flash`'s forward (`_kernel` under `_fwd_with_stats`
and `flash_attention_bhsd`, :37-120 and :220-250): the hand-written CUDA
kernel in `repro_torch/csrc/flash.cu`, its launcher and launch counter,
its plain-torch version, and the Hopper shared-memory size that replaces
`vmem_bytes`.

    out, lse = flash_fwd(q, k, v, cfg, causal=True)

q: (B, Sq, H, Hd); k/v: (B, Skv, KvH, Hd), in the model's layout, with
H % KvH == 0 (head h reads kv head h // (H // KvH)). Returns out
(B, Sq, H, Hd) in q's dtype and lse (B*H, Sq) f32, lse = m + log l of the
online softmax. A CUDA tensor launches the kernel (bf16, Hd 64 or 128,
blk_q in 16..128 by 16s, blk_kv in 32/64/128) or raises; a CPU tensor
takes `flash_fwd_plain`. The kernel reads q/k/v through their strides
(the last axis contiguous), so the model's strided q/k/v views need no
copy; out is written contiguous.

The backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) belong to the
training slice and are not here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HD_INSTANCES = (64, 128)           # head dims compiled in flash.cu
BLK_KV_INSTANCES = (32, 64, 128)   # kv block rows compiled in flash.cu
MAX_BLK_Q = 128                    # 2 * blk_q threads, launch bound 256
SMEM_PER_BLOCK = 232_448           # Hopper opt-in dynamic shared memory
SMEM_PAD = 8                       # bf16 of padding a staged row carries
# registers a thread of each compiled (hd, blk_kv) instance, as nvcc -O3
# lays out flash.cu for sm_90a: chip_smoke.py prints the compiled counts
# (kernel_attrs) beside these; the ranking model reads them for occupancy
REGS_BY_INSTANCE = {(64, 32): 98, (64, 64): 128, (64, 128): 184,
                    (128, 32): 128, (128, 64): 169, (128, 128): 244}


@dataclasses.dataclass(frozen=True)
class FlashBlockConfig:
    name: str = "flash"
    blk_q: int = 64
    blk_kv: int = 64

    def clamped(self, key) -> "FlashBlockConfig":
        """Blocks shrunk to the largest sizes <= the config's that tile
        key.sq and key.skv (the JAX clamp, `kernel_def._div_clamp`)."""
        return dataclasses.replace(self, blk_q=div_clamp(self.blk_q, key.sq),
                                   blk_kv=div_clamp(self.blk_kv, key.skv))

    def threads(self) -> int:
        return 2 * self.blk_q

    def smem_bytes(self, hd: int) -> int:
        """Dynamic shared memory a block stages: the q tile and one K and
        one V tile, bf16, each row padded by SMEM_PAD."""
        return (self.blk_q + 2 * self.blk_kv) * (hd + SMEM_PAD) * 2

    def regs_estimate(self, hd: int) -> int:
        return REGS_BY_INSTANCE.get((hd, self.blk_kv), 256)


def div_clamp(blk: int, s: int) -> int:
    """Largest block <= blk that exactly tiles s (a plain min() clamp on a
    non-dividing length would leave the tail rows uncomputed)."""
    blk = min(blk, s)
    while s % blk:
        blk -= 1
    return blk


def _check_shapes(q, k, v) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q/k/v must be (B, S, H, Hd): {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    if tuple(k.shape) != (b, skv, kvh, hd) or k.shape != v.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % kvh:
        raise ValueError(f"{h} heads are not a multiple of {kvh} kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on {q.device}/{k.device}/{v.device}")
    return b, sq, h, kvh, skv, hd


def _check_tiles(sq: int, skv: int, cfg: FlashBlockConfig) -> None:
    # the divisibility assert of flash_attention_bhsd (flash.py:89)
    if cfg.blk_q <= 0 or cfg.blk_kv <= 0 or sq % cfg.blk_q or skv % cfg.blk_kv:
        raise AssertionError((sq, cfg.blk_q, skv, cfg.blk_kv))


# ---------------------------------------------------------------------------
# plain version (torch): the same kv-block online softmax
# ---------------------------------------------------------------------------

def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: FlashBlockConfig, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch, f32: for every query row, the
    online softmax over kv blocks of cfg.blk_kv in order (m, corr, l, acc
    as flash.py:61-70), then out = acc / max(l, 1e-30) in q's dtype and
    lse = m + log(max(l, 1e-30)). All q rows run at once; a kv block
    above a row's diagonal contributes exactly nothing (p = 0, corr = 1),
    so this equals skipping it as the kernel does. Any Hd and dtype.
    Returns (out (B, Sq, H, Hd), lse (B*H, Sq) f32)."""
    b, sq, h, kvh, skv, hd = _check_shapes(q, k, v)
    _check_tiles(sq, skv, cfg)
    g = h // kvh
    scale = hd ** -0.5
    # (B, KvH, G, Sq, Hd): head h = kvh_index * G + g, as the kernel maps it
    qf = q.float().permute(0, 2, 1, 3).reshape(b, kvh, g, sq, hd)
    acc = torch.zeros_like(qf)
    m = torch.full((b, kvh, g, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    for kv0 in range(0, skv, cfg.blk_kv):
        kb = k[:, kv0:kv0 + cfg.blk_kv].float()          # (B, bkv, KvH, Hd)
        vb = v[:, kv0:kv0 + cfg.blk_kv].float()
        s = torch.einsum("bkgqd,bskd->bkgqs", qf, kb) * scale
        if causal:
            k_pos = kv0 + torch.arange(cfg.blk_kv, device=q.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgqs,bskd->bkgqd", p, vb)
        m = m_new
    den = torch.clamp_min(l, 1e-30)
    out = (acc / den).to(q.dtype)
    lse = (m + torch.log(den)).reshape(b * h, sq)
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3), lse


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash.cu")
    lib.flash_fwd_launch.argtypes = ([_I] * 4 + [_P] * 5 + [_I] * 5
                                     + [_L] * 9 + [ctypes.c_float, _P])
    lib.flash_fwd_launch.restype = _I
    lib.flash_func_attrs.argtypes = [_I, _I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)]
    lib.flash_func_attrs.restype = _I
    return lib


def _check_launchable(q, k, v, cfg: FlashBlockConfig, hd: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}, the kernel needs CUDA")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {x.dtype}, the kernel takes bfloat16")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis is not contiguous")
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"{name}'s rows are not 16-byte aligned "
                             f"(strides {x.stride()})")
    if hd not in HD_INSTANCES:
        raise ValueError(f"head_dim {hd} not compiled (have {HD_INSTANCES})")
    if cfg.blk_kv not in BLK_KV_INSTANCES:
        raise ValueError(f"{cfg}: blk_kv not compiled "
                         f"(have {BLK_KV_INSTANCES})")
    if cfg.blk_q % 16 or not 16 <= cfg.blk_q <= MAX_BLK_Q:
        raise ValueError(f"{cfg}: blk_q must be a multiple of 16 up to "
                         f"{MAX_BLK_Q}")
    if cfg.smem_bytes(hd) > SMEM_PER_BLOCK:
        raise ValueError(f"{cfg}: {cfg.smem_bytes(hd)} B of shared memory "
                         f"> {SMEM_PER_BLOCK}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: FlashBlockConfig, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal (or full) GQA attention forward: the CUDA kernel for CUDA
    tensors (raises if it cannot launch), the plain version for CPU ones.
    Returns (out (B, Sq, H, Hd), lse (B*H, Sq) f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, cfg, causal)
    b, sq, h, kvh, skv, hd = _check_shapes(q, k, v)
    _check_tiles(sq, skv, cfg)
    _check_launchable(q, k, v, cfg, hd)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_fwd_launch(
            hd, cfg.blk_q, cfg.blk_kv, int(causal),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, kvh, sq, skv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {rc} "
                           f"for {cfg} at q {tuple(q.shape)}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def kernel_attrs(hd: int, blk_kv: int) -> Tuple[int, int]:
    """(registers a thread, spilled local bytes) of the compiled (hd,
    blk_kv) instance (card only: builds the library)."""
    regs, local = _I(), _I()
    rc = _lib().flash_func_attrs(hd, blk_kv, ctypes.byref(regs),
                                 ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"flash_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


# ---------------------------------------------------------------------------
# work and traffic (for the ranking model and the bound)
# ---------------------------------------------------------------------------

def visited_pairs(sq: int, skv: int, cfg: FlashBlockConfig,
                  causal: bool) -> int:
    """(q block, kv block) pairs one head's blocks run: the causal loop
    stops after the kv block holding the q block's last row."""
    n_q, n_kv = sq // cfg.blk_q, skv // cfg.blk_kv
    if not causal:
        return n_q * n_kv
    return sum(min(n_kv, (qi * cfg.blk_q + cfg.blk_q - 1) // cfg.blk_kv + 1)
               for qi in range(n_q))


def useful_flops(b: int, h: int, sq: int, skv: int, hd: int,
                 causal: bool) -> float:
    """FLOPs the attention needs on these shapes: 2 products (QK^T, PV) of
    2*hd FLOPs for every score element that is not masked."""
    if causal:
        elems = sum(min(i + 1, skv) for i in range(sq))
    else:
        elems = sq * skv
    return 4.0 * b * h * elems * hd


def min_bytes(b: int, h: int, kvh: int, sq: int, skv: int, hd: int) -> int:
    """Bytes the function must move: q, k, v read once (bf16), out written
    once (bf16), lse written once (f32)."""
    return 2 * b * hd * (2 * sq * h + 2 * skv * kvh) + 4 * b * h * sq
