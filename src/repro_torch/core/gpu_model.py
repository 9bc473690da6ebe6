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

Flash forward (`flash_step_s`) and the selective scan (`ssm_step_s`) are
ranked the same way; the model path takes their picks without timing
(as the JAX package does), so their docstrings say what they count.
"""

from __future__ import annotations

import math

from repro_torch.core.hw import DEFAULT_SPEC, GpuSpec
from repro_torch.kernels.flash import flash_cuda
from repro_torch.kernels.gpp import gpp_cuda
from repro_torch.kernels.gpp.gpp_cuda import BlockConfig
from repro_torch.kernels.gpp.problem import GppSize
from repro_torch.kernels.ssm import ssm_cuda

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


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

# Fitted to csrc/ssm_scan.cu on an H100 SXM5 at 700 W (the blk_c sweep
# chip_smoke.py prints at hymba-1.5b's shapes): a warp issues ~37
# instructions a time step (shared-memory loads, dt*a, expf, the state
# FMA, h*c and its share of the shuffle butterfly), a step takes at least
# ~174 cycles however few warps share the SM (the dependent chain of
# loads, exp and FMAs), and each resident CTA costs ~250 cycles a 64-step
# tile (staging, two barriers, the y write-back).
SSM_INSTR_PER_STEP = 37.0
SSM_STEP_LATENCY_CYCLES = 174.0
SSM_TILE_OVERHEAD_CYCLES = 250.0
SSM_REGS_PER_THREAD = 46              # compiled (chip_smoke.py prints it)
SCHEDULERS_PER_SM = 4


def ssm_resident_blocks(cfg, n: int, spec: GpuSpec = DEFAULT_SPEC) -> int:
    """CTAs of `cfg` (an ssm_cuda.SsmScanConfig) one SM holds at state
    size n."""
    threads = cfg.threads(n)
    regs = -(-SSM_REGS_PER_THREAD // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_threads = spec.max_threads_per_sm // threads
    by_regs = spec.regs_per_sm // (threads * regs)
    by_smem = spec.smem_per_sm // (cfg.smem_bytes(n) + 1024)
    return max(0, min(by_threads, by_regs, by_smem, spec.max_blocks_per_sm))


def ssm_step_s(key, cfg, spec: GpuSpec = DEFAULT_SPEC) -> float:
    """Modeled seconds of one ssm_scan call (key: kernel_def.SsmKey):

        max(sum over the busiest SM's rounds of T x step cycles / clock,
            bytes / HBM bandwidth)

    The busiest SM runs ceil(CTAs / SMs) CTAs, `resident` at a time. A
    round of m CTAs takes T steps of
        max(SSM_STEP_LATENCY_CYCLES, m x warps x SSM_INSTR_PER_STEP / 4)
        + m x SSM_TILE_OVERHEAD_CYCLES / TIME_TILE
    cycles (warps include the padding lanes of a CTA whose blk_c x N is
    not a multiple of 32). Bytes: `ssm_cuda.kernel_hbm_bytes`."""
    resident = ssm_resident_blocks(cfg, key.n, spec)
    if resident == 0:
        return math.inf
    warps = cfg.threads(key.n) // 32
    per_sm = math.ceil(key.b * (key.c // cfg.blk_c) / spec.sms)
    cycles = 0.0
    while per_sm > 0:
        m = min(resident, per_sm)
        per_sm -= m
        step = max(SSM_STEP_LATENCY_CYCLES,
                   m * warps * SSM_INSTR_PER_STEP / SCHEDULERS_PER_SM)
        step += m * SSM_TILE_OVERHEAD_CYCLES / ssm_cuda.TIME_TILE
        cycles += key.t * step
    bytes_ = ssm_cuda.kernel_hbm_bytes(key.b, key.t, key.c, key.n)
    return max(cycles / spec.boost_hz, bytes_ / spec.hbm_bw)
