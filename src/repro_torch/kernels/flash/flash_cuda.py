"""Flash attention for Hopper — the port of `repro.kernels.flash.flash`:
the forward (`_kernel` under `_fwd_with_stats` and `flash_attention_bhsd`,
:37-120 and :220-250), the two backward kernels (`_bwd_dq_kernel`,
`_bwd_dkv_kernel`, :142-216) and the custom VJP around them
(`flash_attention_diff`, :253-311). For each kernel: the hand-written CUDA
kernel (`repro_torch/csrc/flash.cu`, `csrc/flash_bwd.cu`, both built on
the shared Hopper helpers of `csrc/sm90.cuh`), its launcher and launch
counter, and its plain-torch version; plus the Hopper shared-memory size
that replaces `vmem_bytes`.

    out, lse = flash_fwd(q, k, v, cfg, causal=True)

q: (B, Sq, H, Hd); k/v: (B, Skv, KvH, Hd), in the model's layout, with
H % KvH == 0 (head h reads kv head h // (H // KvH)). Returns out
(B, Sq, H, Hd) in q's dtype and lse (B*H, Sq) f32, lse = m + log l of the
online softmax. A CUDA tensor launches the kernel (bf16, Hd 64 or 128,
blk_q 64 or 128, blk_kv 64 or 128) or raises; a CPU tensor takes
`flash_fwd_plain`. Hd 32 runs on the Hd 64 instances: every wrapper
zero-pads q, k, v (and dout) to Hd 64, launches with the scale of the true
head dim, 1/sqrt(32), and slices the result back to 32 columns; the
padded columns add exact zeros to every product (PAD_HEAD_DIM). The
kernel reads q/k/v through their strides with TMA (the last axis
contiguous, 16-byte rows), so the model's strided q/k/v views need no
copy; out is written contiguous.

    dq = flash_bwd_dq(q, k, v, dout, lse, delta, dq_cfg, causal=True)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, dkv_cfg, causal=True)

take the forward's q/k/v and lse, dout (B, Sq, H, Hd) and delta =
rowsum(dout * out) (B*H, Sq) f32, and return dq (B, Sq, H, Hd) and dk/dv
(B, Skv, KvH, Hd) in q's dtype. dk/dv are summed over the kv head's group
of q heads in q-head order: inside a thread-block cluster for groups of
up to 8, through f32 per-q-head partials and a second kernel above. A
CUDA tensor launches the kernel (bf16, Hd 64 or 128, or 32 padded; dq:
blk_q 64, blk_kv 64 or 128; dkv: blk_q 32 or 64, blk_kv 64) or raises; a
CPU tensor takes the plain version. `FlashAttention` (a
torch.autograd.Function) and `flash_attention_diff(q, k, v, cfg, causal)`
put the three together: the forward saves q, k, v, out and lse, and the
backward computes delta with torch and launches both backward kernels,
each under its own blocks (`bwd_configs`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.hw import DEFAULT_SPEC
from repro_torch.kernels import _build

NEG_INF = -1e30
HD_INSTANCES = (64, 128)           # head dims compiled in flash.cu
# head dims the wrappers zero-pad to a compiled one (the padded columns add
# exact zeros to q k^T, P V, ds k, ds^T q and p^T dout; the scale stays the
# true head dim's)
PAD_HEAD_DIM = {32: 64}
# the forward's compiled blocks (csrc/flash.cu): 64 query rows a consumer
# warpgroup (wgmma's M), one or two warpgroups a CTA; blk_kv rows a stage
# of the 2-stage K/V ring
BLK_Q_INSTANCES = (64, 128)
BLK_KV_INSTANCES = (64, 128)
KV_STAGES = 2
SMEM_PER_BLOCK = 232_448           # Hopper opt-in dynamic shared memory
SMEM_ALIGN = 1024                  # the swizzled tiles start on 1 KiB
# registers a thread of each compiled (hd, blk_q, blk_kv) instance, as
# nvcc -O3 (12.8) lays out flash.cu for sm_90a (launch bounds: 160
# threads x 2 CTAs an SM at blk_q 64, 288 x 1 at 128, both capping a
# thread at 168): chip_smoke.py prints the compiled counts (kernel_attrs)
# beside these; the ranking model reads them for occupancy
REGS_BY_INSTANCE = {(64, 64, 64): 128, (64, 64, 128): 168,
                    (64, 128, 64): 128, (64, 128, 128): 168,
                    (128, 64, 64): 161, (128, 64, 128): 168,
                    (128, 128, 64): 161, (128, 128, 128): 168}
# the backward kernels' compiled blocks (csrc/flash_bwd.cu), both wgmma
# kernels of one warpgroup a CTA (128 threads, launch bounds 2 CTAs an SM).
# dq: 64 q rows a CTA (DQ_BLK_Q), blk_kv (a stage of its DQ_STAGES-stage
# K/V ring) 64 or 128. dkv: 64 kv rows a CTA, blk_q (its q stage) 32 or
# 64; groups of up to MAX_CLUSTER q heads sum in one thread-block cluster
DQ_BLK_Q = 64
DQ_BLK_KV_INSTANCES = (64, 128)
DQ_STAGES = 2
DQ_THREADS = 128
# registers a thread of each compiled dq (hd, blk_kv) instance, as nvcc
# -O3 (12.8) lays out flash_bwd.cu for sm_90a: chip_smoke.py prints the
# compiled counts (bwd_kernel_attrs) beside these
DQ_REGS_BY_INSTANCE = {(64, 64): 127, (64, 128): 197,
                       (128, 64): 161, (128, 128): 227}
DKV_BLK_Q_INSTANCES = (32, 64)
DKV_BLK_KV = 64
MAX_CLUSTER = 8


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
        """The forward CTA: blk_q / 64 consumer warpgroups and one
        producer warp."""
        return 2 * self.blk_q + 32

    def smem_bytes(self, hd: int) -> int:
        """Dynamic shared memory a forward CTA asks for: the q tile and
        KV_STAGES stages of one K and one V tile, bf16, unpadded (the
        tiles are 128-byte swizzled), the ring's mbarriers and the slack
        to align the tiles to SMEM_ALIGN."""
        return ((self.blk_q + 2 * KV_STAGES * self.blk_kv) * hd * 2 + 64
                + SMEM_ALIGN)

    def regs_estimate(self, hd: int) -> int:
        return REGS_BY_INSTANCE.get((hd, self.blk_q, self.blk_kv), 256)


# the backward's blocks before clamping to the shape, one pair a kernel,
# picked from the compiled registers and spills (nvcc 12.8 for sm_90a;
# chip_smoke.py prints them). dq: 64 q rows a CTA (one warpgroup holding
# dq, 64 f32 a thread at Hd 128) stepping 64 kv rows, two CTAs an SM.
# dkv: 64 kv rows a CTA (one warpgroup holding dk and dv, 128 f32 a
# thread at Hd 128) stepping 64 query rows a stage.
DQ_BLOCKS = FlashBlockConfig("bwd-dq", DQ_BLK_Q, 64)
DKV_BLOCKS = FlashBlockConfig("bwd-dkv", 64, DKV_BLK_KV)


def dq_smem_bytes(hd: int, blk_kv: int) -> int:
    """Dynamic shared memory a dq CTA asks for: the q and dout tiles, the
    DQ_STAGES-stage ring of one K and one V tile (bf16, 128-byte
    swizzled, unpadded), the lse and delta rows (f32), the mbarriers and
    the slack to align the tiles to SMEM_ALIGN."""
    tiles = (2 * DQ_BLK_Q + DQ_STAGES * 2 * blk_kv) * hd * 2
    return tiles + 2 * DQ_BLK_Q * 4 + 64 + SMEM_ALIGN


def dq_resident_ctas(hd: int, blk_kv: int, spec=None) -> int:
    """dq CTAs of (hd, blk_kv) one SM holds at once: the fewest its
    shared memory, its registers (DQ_REGS_BY_INSTANCE, allocated in 8s)
    and the launch bounds (2) allow."""
    spec = spec or DEFAULT_SPEC
    regs = -(-DQ_REGS_BY_INSTANCE.get((hd, blk_kv), 256) // 8) * 8
    by_regs = spec.regs_per_sm // (DQ_THREADS * regs)
    by_smem = spec.smem_per_sm // (dq_smem_bytes(hd, blk_kv) + 1024)
    return min(2, by_regs, by_smem)


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
                    cfg: FlashBlockConfig, causal: bool = True,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in torch, f32: for every query row, the
    online softmax over kv blocks of cfg.blk_kv in order (m, corr, l, acc
    as flash.py:61-70), then out = acc / max(l, 1e-30) in q's dtype and
    lse = m + log(max(l, 1e-30)). All q rows run at once; a kv block
    above a row's diagonal contributes exactly nothing (p = 0, corr = 1),
    so this equals skipping it as the kernel does. Any Hd and dtype; the
    softmax scale is hd ** -0.5 unless `scale` is given (a zero-padded
    head dim keeps its true one). Returns (out (B, Sq, H, Hd), lse (B*H,
    Sq) f32)."""
    b, sq, h, kvh, skv, hd = _check_shapes(q, k, v)
    _check_tiles(sq, skv, cfg)
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
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
# head dims without an instance: zero-padded to one
# ---------------------------------------------------------------------------

def run_head_dim(hd: int) -> int:
    """The compiled head dim a call at head dim `hd` launches: hd itself,
    or the instance PAD_HEAD_DIM pads it to."""
    return PAD_HEAD_DIM.get(hd, hd)


def pad_head_dim(x: torch.Tensor, hd: int) -> torch.Tensor:
    """x (B, S, heads, Hd) with its last axis zero-padded to hd columns
    (x itself when it has hd already)."""
    if x.shape[-1] == hd:
        return x
    return torch.nn.functional.pad(x, (0, hd - x.shape[-1]))


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
    lib.flash_func_attrs.argtypes = [_I, _I, _I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)]
    lib.flash_func_attrs.restype = _I
    return lib


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether the kernels can read x (B, S, heads, Hd) through its
    strides: the last axis contiguous and every row on a 16-byte
    boundary."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and not any(st % 8 for st in x.stride()[:3]))


def _check_operands(hd: int, **tensors) -> None:
    for name, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}, the kernel needs CUDA")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {x.dtype}, the kernel takes bfloat16")
        if not rows_aligned(x):
            raise ValueError(f"{name}'s rows are not contiguous and 16-byte "
                             f"aligned (strides {x.stride()})")
    if hd not in HD_INSTANCES:
        raise ValueError(f"head_dim {hd} not compiled (have {HD_INSTANCES})")


def _check_launchable(q, k, v, cfg: FlashBlockConfig, hd: int) -> None:
    _check_operands(hd, q=q, k=k, v=v)
    if cfg.blk_kv not in BLK_KV_INSTANCES:
        raise ValueError(f"{cfg}: blk_kv not compiled "
                         f"(have {BLK_KV_INSTANCES})")
    if cfg.blk_q not in BLK_Q_INSTANCES:
        raise ValueError(f"{cfg}: blk_q not compiled "
                         f"(have {BLK_Q_INSTANCES})")
    if cfg.smem_bytes(hd) > SMEM_PER_BLOCK:
        raise ValueError(f"{cfg}: {cfg.smem_bytes(hd)} B of shared memory "
                         f"> {SMEM_PER_BLOCK}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: FlashBlockConfig, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal (or full) GQA attention forward: the CUDA kernel for CUDA
    tensors (raises if it cannot launch; a head dim in PAD_HEAD_DIM runs
    zero-padded), the plain version for CPU ones. Returns (out (B, Sq, H,
    Hd), lse (B*H, Sq) f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, cfg, causal)
    b, sq, h, kvh, skv, hd = _check_shapes(q, k, v)
    _check_tiles(sq, skv, cfg)
    hd_run = run_head_dim(hd)
    q, k, v = (pad_head_dim(x, hd_run) for x in (q, k, v))
    _check_launchable(q, k, v, cfg, hd_run)
    out = torch.empty((b, sq, h, hd_run), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_fwd_launch(
            hd_run, cfg.blk_q, cfg.blk_kv, int(causal),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, kvh, sq, skv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {rc} "
                           f"for {cfg} at q {tuple(q.shape)}")
    flash_fwd.launches += 1
    if hd_run != hd:
        out = out[..., :hd].contiguous()
    return out, lse


flash_fwd.launches = 0


def kernel_attrs(hd: int, blk_q: int, blk_kv: int) -> Tuple[int, int]:
    """(registers a thread at launch, spilled local bytes) of the compiled
    (hd, blk_q, blk_kv) instance (card only: builds the library)."""
    regs, local = _I(), _I()
    rc = _lib().flash_func_attrs(hd, blk_q, blk_kv, ctypes.byref(regs),
                                 ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"flash_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


# ---------------------------------------------------------------------------
# backward: plain versions (torch)
# ---------------------------------------------------------------------------

def _check_stats(lse: torch.Tensor, delta: torch.Tensor, bh: int, sq: int,
                 device) -> None:
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (bh, sq) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be ({bh}, {sq}) float32: "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")


def _bwd_setup(q, k, v, dout, lse, delta, cfg):
    b, sq, h, kvh, skv, hd = _check_shapes(q, k, v)
    if tuple(dout.shape) != tuple(q.shape) or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} on {dout.device} does "
                         f"not match q {tuple(q.shape)} on {q.device}")
    _check_tiles(sq, skv, cfg)
    _check_stats(lse, delta, b * h, sq, q.device)
    return b, sq, h, kvh, skv, hd


def _planar_groups(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, Hd) -> (B, KvH, G, S, Hd) f32: head h = kv head h // G."""
    b, s, h, hd = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b, kvh, h // kvh, s, hd)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, cfg: FlashBlockConfig,
                       causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """dq of `_bwd_dq_kernel` in torch, f32: for every query row, over kv
    blocks of cfg.blk_kv in order, p = exp(q k^T * scale - lse) (the
    causal mask as NEG_INF before the exp), ds = p * (dout v^T - delta) *
    scale, dq += ds k; cast once to q's dtype. A kv block above a row's
    diagonal contributes exactly 0, so this equals skipping it as the
    kernel does. scale: hd ** -0.5 unless given. Returns dq (B, Sq, H,
    Hd)."""
    b, sq, h, kvh, skv, hd = _bwd_setup(q, k, v, dout, lse, delta, cfg)
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qf, of = _planar_groups(q, kvh), _planar_groups(dout, kvh)
    lse_r = lse.reshape(b, kvh, g, sq, 1)
    dd = delta.reshape(b, kvh, g, sq, 1)
    dq = torch.zeros_like(qf)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    for kv0 in range(0, skv, cfg.blk_kv):
        kb = k[:, kv0:kv0 + cfg.blk_kv].float()          # (B, bkv, KvH, Hd)
        vb = v[:, kv0:kv0 + cfg.blk_kv].float()
        s = torch.einsum("bkgqd,bskd->bkgqs", qf, kb) * scale
        if causal:
            k_pos = kv0 + torch.arange(cfg.blk_kv, device=q.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse_r)
        dp = torch.einsum("bkgqd,bskd->bkgqs", of, vb)
        ds = p * (dp - dd) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds, kb)
    return dq.reshape(b, h, sq, hd).permute(0, 2, 1, 3).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, cfg: FlashBlockConfig,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv of `_bwd_dkv_kernel` and the group sum after it
    (flash.py:296-306) in torch, f32: for every q head, over q blocks of
    cfg.blk_q in order, dv_h += p^T dout and dk_h += ds^T q (the JAX
    per-q-head partials); then each kv head's dk = dk_h0 + dk_h1 + ... in
    q-head order, as the kernel's fixed-order group sum; cast once to k's
    dtype. scale: hd ** -0.5 unless given. Returns (dk, dv), each (B, Skv,
    KvH, Hd)."""
    b, sq, h, kvh, skv, hd = _bwd_setup(q, k, v, dout, lse, delta, cfg)
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qf, of = _planar_groups(q, kvh), _planar_groups(dout, kvh)
    kf = k.float().permute(0, 2, 1, 3)                   # (B, KvH, Skv, Hd)
    vf = v.float().permute(0, 2, 1, 3)
    lse_r = lse.reshape(b, kvh, g, sq, 1)
    dd = delta.reshape(b, kvh, g, sq, 1)
    dk_h = torch.zeros((b, kvh, g, skv, hd), dtype=torch.float32,
                       device=q.device)
    dv_h = torch.zeros_like(dk_h)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    for q0 in range(0, sq, cfg.blk_q):
        rows = slice(q0, q0 + cfg.blk_q)
        qb, ob = qf[:, :, :, rows], of[:, :, :, rows]
        s = torch.einsum("bkgqd,bksd->bkgqs", qb, kf) * scale
        if causal:
            q_pos = q0 + torch.arange(cfg.blk_q, device=q.device)[:, None]
            s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse_r[:, :, :, rows])
        dv_h = dv_h + torch.einsum("bkgqs,bkgqd->bkgsd", p, ob)
        dp = torch.einsum("bkgqd,bksd->bkgqs", ob, vf)
        ds = p * (dp - dd[:, :, :, rows]) * scale
        dk_h = dk_h + torch.einsum("bkgqs,bkgqd->bkgsd", ds, qb)
    dk, dv = dk_h[:, :, 0], dv_h[:, :, 0]
    for i in range(1, g):
        dk = dk + dk_h[:, :, i]
        dv = dv + dv_h[:, :, i]
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ---------------------------------------------------------------------------
# backward: kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_bwd.cu")
    lib.flash_bwd_dq_launch.argtypes = ([_I] * 4 + [_P] * 7 + [_I] * 5
                                        + [_L] * 12 + [ctypes.c_float, _P])
    lib.flash_bwd_dq_launch.restype = _I
    lib.flash_bwd_dkv_launch.argtypes = ([_I] * 4 + [_P] * 9 + [_I] * 5
                                         + [_L] * 12 + [ctypes.c_float, _P])
    lib.flash_bwd_dkv_launch.restype = _I
    lib.flash_bwd_dkv_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    lib.flash_bwd_dkv_occupancy.restype = _I
    lib.flash_bwd_func_attrs.argtypes = [_I, _I, _I, ctypes.POINTER(_I),
                                         ctypes.POINTER(_I)]
    lib.flash_bwd_func_attrs.restype = _I
    return lib


def _check_bwd_launchable(kernel: str, q, k, v, dout, lse, delta, hd: int,
                          cfg: FlashBlockConfig) -> None:
    _check_operands(hd, q=q, k=k, v=v, dout=dout)
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("lse and delta must be contiguous")
    if lse.data_ptr() % 16 or delta.data_ptr() % 16:
        raise ValueError("lse and delta must start on 16-byte boundaries")
    if kernel == "dq":
        if cfg.blk_q != DQ_BLK_Q or cfg.blk_kv not in DQ_BLK_KV_INSTANCES:
            raise ValueError(f"{cfg}: dq takes blk_q {DQ_BLK_Q} and blk_kv "
                             f"in {DQ_BLK_KV_INSTANCES}")
        if dq_smem_bytes(hd, cfg.blk_kv) > SMEM_PER_BLOCK:
            raise ValueError(f"{cfg}: {dq_smem_bytes(hd, cfg.blk_kv)} B of "
                             f"shared memory > {SMEM_PER_BLOCK}")
        return
    if cfg.blk_q not in DKV_BLK_Q_INSTANCES or cfg.blk_kv != DKV_BLK_KV:
        raise ValueError(f"{cfg}: dkv takes blk_q in {DKV_BLK_Q_INSTANCES} "
                         f"and blk_kv {DKV_BLK_KV}")


def _bwd_args(q, k, v, dout):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3])


def flash_bwd_dq(q, k, v, dout, lse, delta, cfg: FlashBlockConfig,
                 causal: bool = True) -> torch.Tensor:
    """dq (B, Sq, H, Hd): the CUDA kernel for CUDA tensors (raises if it
    cannot launch; blk_q = 64 query rows a CTA, blk_kv kv rows a ring
    stage; a head dim in PAD_HEAD_DIM runs zero-padded), the plain version
    for CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, cfg, causal)
    b, sq, h, kvh, skv, hd = _bwd_setup(q, k, v, dout, lse, delta, cfg)
    hd_run = run_head_dim(hd)
    q, k, v, dout = (pad_head_dim(x, hd_run) for x in (q, k, v, dout))
    _check_bwd_launchable("dq", q, k, v, dout, lse, delta, hd_run, cfg)
    dq = torch.empty((b, sq, h, hd_run), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _bwd_lib().flash_bwd_dq_launch(
            hd_run, cfg.blk_q, cfg.blk_kv, int(causal), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, kvh, sq, skv,
            *_bwd_args(q, k, v, dout), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed with CUDA error {rc} "
                           f"for {cfg} at q {tuple(q.shape)}")
    flash_bwd_dq.launches += 1
    return dq if hd_run == hd else dq[..., :hd].contiguous()


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, cfg: FlashBlockConfig,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Skv, KvH, Hd), summed over each kv head's q
    heads in q-head order: the CUDA kernel for CUDA tensors (raises if it
    cannot launch; blk_kv = 64 kv rows of one q head a CTA, blk_q query
    rows a stage; a group of more than MAX_CLUSTER q heads goes through
    (2, B, Skv, H, Hd) f32 partials allocated here), the plain version for
    CPU ones; a head dim in PAD_HEAD_DIM runs zero-padded."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, cfg, causal)
    b, sq, h, kvh, skv, hd = _bwd_setup(q, k, v, dout, lse, delta, cfg)
    hd_run = run_head_dim(hd)
    q, k, v, dout = (pad_head_dim(x, hd_run) for x in (q, k, v, dout))
    _check_bwd_launchable("dkv", q, k, v, dout, lse, delta, hd_run, cfg)
    dk = torch.empty((b, skv, kvh, hd_run), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    part = (torch.empty((2, b, skv, h, hd_run), dtype=torch.float32,
                        device=q.device) if h // kvh > MAX_CLUSTER else None)
    with torch.cuda.device(q.device):
        rc = _bwd_lib().flash_bwd_dkv_launch(
            hd_run, cfg.blk_q, cfg.blk_kv, int(causal), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), b, h, kvh, sq,
            skv, *_bwd_args(q, k, v, dout), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed with CUDA error "
                           f"{rc} for {cfg} at q {tuple(q.shape)}")
    flash_bwd_dkv.launches += 1
    if hd_run != hd:
        dk, dv = dk[..., :hd].contiguous(), dv[..., :hd].contiguous()
    return dk, dv


flash_bwd_dkv.launches = 0


def bwd_kernel_attrs(kind: str, hd: int, inner: int) -> Tuple[int, int]:
    """(registers a thread, spilled local bytes) of the compiled backward
    instance: kind "dq" (inner = blk_kv) or "dkv" (inner = blk_q); card
    only (builds the library)."""
    regs, local = _I(), _I()
    rc = _bwd_lib().flash_bwd_func_attrs(("dq", "dkv").index(kind), hd, inner,
                                         ctypes.byref(regs),
                                         ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_func_attrs failed with CUDA error {rc}")
    return regs.value, local.value


def dkv_cluster_occupancy(hd: int, blk_q: int, group: int) -> int:
    """Clusters of `group` flash_bwd_dkv CTAs the card holds at once
    (cudaOccupancyMaxActiveClusters; card only)."""
    n = _I()
    rc = _bwd_lib().flash_bwd_dkv_occupancy(hd, blk_q, group, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv_occupancy failed with CUDA error "
                           f"{rc}")
    return n.value


# ---------------------------------------------------------------------------
# the differentiable attention (the custom VJP of flash.py:253-311)
# ---------------------------------------------------------------------------

def bwd_configs(sq: int, skv: int
                ) -> Tuple[FlashBlockConfig, FlashBlockConfig]:
    """The backward's blocks, (dq's, dkv's): DQ_BLOCKS and DKV_BLOCKS
    clamped to the shape."""
    return tuple(dataclasses.replace(c, blk_q=div_clamp(c.blk_q, sq),
                                     blk_kv=div_clamp(c.blk_kv, skv))
                 for c in (DQ_BLOCKS, DKV_BLOCKS))


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) with the flash kernels both ways. forward
    runs flash_fwd under `cfg` and saves q, k, v, out and lse; backward
    computes delta = rowsum(dout * out) in f32 with torch (as the JAX
    backward does outside Pallas, flash.py:272) and launches flash_bwd_dq
    and flash_bwd_dkv under `bwd_cfgs` (dq's, dkv's). A dout whose rows the
    kernels cannot read through strides is copied contiguous first (one
    (B, S, H, Hd) bf16 copy); the model's dout needs none."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, causal, bwd_cfgs):
        out, lse = flash_fwd(q, k, v, cfg, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.bwd_cfgs = causal, bwd_cfgs
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.is_cuda and not rows_aligned(dout):
            dout = dout.contiguous()
        b, sq, h, _ = q.shape
        delta = (dout.float() * out.float()).sum(-1)     # (B, Sq, H)
        delta = delta.permute(0, 2, 1).reshape(b * h, sq).contiguous()
        dq_cfg, dkv_cfg = ctx.bwd_cfgs
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, dq_cfg, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, dkv_cfg, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention_diff(q, k, v, cfg: FlashBlockConfig, causal: bool = True
                         ) -> torch.Tensor:
    """Differentiable flash attention, q: (B, Sq, H, Hd), k/v: (B, Skv,
    KvH, Hd) -> out (B, Sq, H, Hd): the forward under cfg, the backward
    under `bwd_configs`. Under torch.no_grad, or when no input requires
    grad, it records nothing and saves nothing."""
    return FlashAttention.apply(q, k, v, cfg, causal,
                                bwd_configs(q.shape[1], k.shape[1]))


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
    return 4.0 * b * h * attended_elems(sq, skv, causal) * hd


def min_bytes(b: int, h: int, kvh: int, sq: int, skv: int, hd: int) -> int:
    """Bytes the function must move: q, k, v read once (bf16), out written
    once (bf16), lse written once (f32)."""
    return 2 * b * hd * (2 * sq * h + 2 * skv * kvh) + 4 * b * h * sq


def attended_elems(sq: int, skv: int, causal: bool) -> int:
    """Score elements one head needs: those on or below the diagonal when
    causal."""
    if causal:
        return sum(min(i + 1, skv) for i in range(sq))
    return sq * skv


def bwd_useful_flops(b: int, h: int, sq: int, skv: int, hd: int,
                     causal: bool, kernel: str) -> float:
    """FLOPs one backward kernel needs: 2*hd for every product and score
    element that is not masked — dq recomputes s and forms dp and ds k (3
    products), dkv recomputes s and forms dp, p^T dout and ds^T q (4)."""
    products = {"dq": 3, "dkv": 4}[kernel]
    return 2.0 * products * hd * b * h * attended_elems(sq, skv, causal)


def bwd_min_bytes(b: int, h: int, kvh: int, sq: int, skv: int, hd: int,
                  kernel: str) -> int:
    """Bytes one backward kernel must move: q, dout, k, v read once
    (bf16), lse and delta once (f32); dq (dq) or dk and dv (dkv) written
    once (bf16)."""
    q_bytes = 2 * b * sq * h * hd
    kv_bytes = 2 * b * skv * kvh * hd
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * b * h * sq
    return reads + (q_bytes if kernel == "dq" else 2 * kv_bytes)
