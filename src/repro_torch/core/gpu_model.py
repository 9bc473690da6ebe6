"""Hopper ranking models for the port's kernels — the tuner's ranking
functions, the counterpart of `repro.core.vpu_model` (which models the
TPU's VPU passes, lane fill and grid overhead, none of which a GPU has).

GPP (`step_s`):

    step_s = max(issue_s x wave_quantisation, bytes / HBM bandwidth)

  issue_s     the terms' FP32 instructions over the card's issue rate
              (SMs x 128 lanes x clock): ~71 a GPP term, the v9 census
              (54 basic + 14 FMA + 3 reciprocals).
  wave_quantisation
              blocks ÷ (SMs x resident blocks), rounded up to whole waves,
              over the same ratio unrounded: a last partial wave leaves
              SMs idle. Resident blocks a SM holds are limited by threads,
              registers (gpp_cuda.REGS_BY_EPT) and shared memory.
  bytes       `gpp_cuda.hbm_traffic_model`.

It ranks configs; it does not predict a measured time closely (latency
with few resident warps, the reciprocals' MUFU work and the staging are
not in it), so the tuner times the model's top picks and the static v9
config on the card, and the timing decides.
"""

from __future__ import annotations

import math

from repro_torch.core.hw import DEFAULT_SPEC, GpuSpec
from repro_torch.kernels.flash import flash_cuda
from repro_torch.kernels.gpp import gpp_cuda
from repro_torch.kernels.gpp.gpp_cuda import BlockConfig
from repro_torch.kernels.gpp.problem import GppSize

# the flash kernel's products run through warp-level mma.sync, not wgmma
# (the only path to the card's full tensor-core rate): taken as half of
# the dense bf16 peak — an assumption for ranking, not a measurement
MMA_SYNC_SHARE = 0.5
INSTR_PER_TERM = 54.0 + 14.0 + 3.0     # basic + fma + rcp, core/vpu_model v9
REG_ALLOC_UNIT = 8                     # registers are allocated in 8s


def resident_blocks(cfg: BlockConfig, spec: GpuSpec = DEFAULT_SPEC,
                    nw: int = 2) -> int:
    """Blocks of `cfg` one SM holds at once (0 = does not fit)."""
    regs = -(-cfg.regs_estimate() // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_threads = spec.max_threads_per_sm // cfg.threads
    by_regs = spec.regs_per_sm // (cfg.threads * regs)
    by_smem = spec.smem_per_sm // (cfg.smem_bytes(nw) + 1024)  # 1 KiB reserved
    return max(0, min(by_threads, by_regs, by_smem, spec.max_blocks_per_sm))


def wave_quantisation(size: GppSize, cfg: BlockConfig,
                      spec: GpuSpec = DEFAULT_SPEC) -> float:
    blocks = gpp_cuda.grid_blocks(size, cfg)
    slots = spec.sms * resident_blocks(cfg, spec, size.nw)
    if slots == 0:
        return math.inf
    return math.ceil(blocks / slots) * slots / blocks


def step_terms(size: GppSize, cfg: BlockConfig, spec: GpuSpec = DEFAULT_SPEC):
    """(compute_s incl. wave quantisation, memory_s)."""
    compute = (size.inner_iters * INSTR_PER_TERM / spec.fp32_lane_ops_per_s
               * wave_quantisation(size, cfg, spec))
    memory = gpp_cuda.hbm_traffic_model(size, cfg) / spec.hbm_bw
    return compute, memory


def step_s(size: GppSize, cfg: BlockConfig, spec: GpuSpec = DEFAULT_SPEC) -> float:
    """Modeled seconds of one GPP kernel call under `cfg` on `spec`."""
    return max(step_terms(size, cfg, spec))


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------

def flash_resident_blocks(cfg, hd: int, spec: GpuSpec = DEFAULT_SPEC) -> int:
    """Blocks of `cfg` (a flash_cuda.FlashBlockConfig) one SM holds."""
    threads = cfg.threads()
    regs = -(-cfg.regs_estimate(hd) // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_threads = spec.max_threads_per_sm // threads
    by_regs = spec.regs_per_sm // (threads * regs)
    by_smem = spec.smem_per_sm // (cfg.smem_bytes(hd) + 1024)
    return max(0, min(by_threads, by_regs, by_smem, spec.max_blocks_per_sm))


def flash_step_s(key, cfg, spec: GpuSpec = DEFAULT_SPEC) -> float:
    """Modeled seconds of one flash_fwd call (key: kernel_def.FlashKey):

        max(mma FLOPs of the visited pairs / the mma.sync rate,
            bytes / HBM bandwidth) x wave quantisation

    mma FLOPs: each visited (q, kv) block pair computes blk_q x blk_kv
    scores with 2*hd FLOPs for QK^T and 2 x 2*hd for PV (P split into a
    bf16 high and low part), masked or not. Bytes: q, out and lse once,
    K and V once for each visited pair (L2 hits counted as misses). Wave
    quantisation over the B*H x n_q blocks, as for GPP."""
    bh = key.b * key.h
    pairs = flash_cuda.visited_pairs(key.sq, key.skv, cfg, key.causal)
    elems = bh * pairs * cfg.blk_q * cfg.blk_kv
    mma_s = 6.0 * elems * key.hd / (spec.bf16_tc_flops * MMA_SYNC_SHARE)
    bytes_ = bh * (key.sq * key.hd * 2 * 2 + key.sq * 4
                   + pairs * 2 * cfg.blk_kv * key.hd * 2)
    blocks = bh * (key.sq // cfg.blk_q)
    slots = spec.sms * flash_resident_blocks(cfg, key.hd, spec)
    if slots == 0:
        return math.inf
    waves = math.ceil(blocks / slots) * slots / blocks
    return max(mma_s, bytes_ / spec.hbm_bw) * waves
