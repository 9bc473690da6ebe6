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

# flash_fwd's consumer warpgroups (64 query rows each) wait on their own
# wgmma before the softmax that follows it, so one warpgroup alone leaves
# the SM's tensor cores idle for the softmax; two on an SM (two in one
# CTA, or two CTAs) overlap one's softmax with the other's products. Taken
# as the tensor-core share a warpgroup alone reaches, for ranking, not a
# measurement
FLASH_LONE_WG_SHARE = 0.5
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

        max(wgmma FLOPs of the visited pairs / (bf16 peak x share),
            bytes / HBM bandwidth) x SM quantisation

    wgmma FLOPs: each visited (q, kv) block pair computes blk_q x blk_kv
    scores with 2*hd FLOPs for QK^T and 2 x 2*hd for PV (P split into a
    bf16 high and low part: 1.5x the useful work), masked or not, at the
    dense bf16 rate wgmma reaches. share: 1 when two consumer warpgroups
    run on an SM (resident CTAs from threads, registers and shared memory,
    times blk_q / 64), FLASH_LONE_WG_SHARE when one does. Bytes: q, out,
    lse, K and V once (`flash_cuda.min_bytes`): a kv head's K and V are
    read again by every q block and every q head of its group, but at the
    shapes the port runs they are a few MB and stay in the 50 MB L2 (the
    device-timed sweep chip_smoke.py phase 7 prints finds 64-row blocks,
    which read K/V twice as often, the fastest at S=4096).
    SM quantisation: the busiest SM gets ceil(CTAs / SMs) of the B*H x n_q
    CTAs, however many of them are resident at once (they share its tensor
    cores)."""
    bh = key.b * key.h
    pairs = flash_cuda.visited_pairs(key.sq, key.skv, cfg, key.causal)
    elems = bh * pairs * cfg.blk_q * cfg.blk_kv
    blocks = bh * (key.sq // cfg.blk_q)
    resident = flash_resident_blocks(cfg, key.hd, spec)
    if resident == 0:
        return math.inf
    per_sm = min(resident, math.ceil(blocks / spec.sms))
    share = 1.0 if per_sm * cfg.blk_q // 64 >= 2 else FLASH_LONE_WG_SHARE
    mma_s = 6.0 * elems * key.hd / (spec.bf16_tc_flops * share)
    bytes_ = flash_cuda.min_bytes(key.b, key.h, key.kvh, key.sq, key.skv,
                                  key.hd)
    quant = math.ceil(blocks / spec.sms) * spec.sms / blocks
    return max(mma_s, bytes_ / spec.hbm_bw) * quant


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
