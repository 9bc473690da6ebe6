"""Hopper ranking models for the port's kernels — the tuner's ranking
functions, the counterpart of `repro.core.vpu_model` (which models the
TPU's VPU passes, lane fill and grid overhead, none of which a GPU has).

GPP (`step_s`):

    step_s = max(issue_s x wave_quantisation, bytes / HBM bandwidth)

  issue_s     the terms' instructions over the card's issue rate (SMs x
              4 schedulers x 32 lanes x clock): the count of
              csrc/gpp.cu's band loop in its SASS (core/sass.py;
              chip_smoke.py phase 2b prints it), `instr_per_term`.
  wave_quantisation
              blocks ÷ (SMs x resident blocks), rounded up to whole waves,
              over the same ratio unrounded: a last partial wave leaves
              SMs idle. Resident blocks a SM holds are limited by threads,
              registers (gpp_cuda.REGS_BY_EPT) and shared memory.
  bytes       `gpp_cuda.hbm_traffic_model`.

It ranks configs; it does not predict a measured time closely (latency
with few resident warps and the staging are not in it; the kernel ran at
~86% of the issue bound it gives), so the tuner times the model's top
picks and the static v9 config on the card, and the timing decides.

Flash forward (`flash_step_s`), the selective scan (`ssm_step_s`) and
paged decode (`paged_step_s`) are ranked the same way; the model path
takes the first two's picks without timing (as the JAX package does), so
their docstrings say what they count.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
# instructions one (ig, igp, band, iw) term issues: the SASS census of
# gpp_fused's band loop at one element a thread (nvcc 12.8, sm_90a; PERF.md
# §6), every class counted (FP32, MUFU, selects, LDS, integer, control),
# on the fast path (the IEEE reciprocals' slow-path call stubs skipped).
# The tuner ranks gpp_fused's configs at this count for every EPT.
INSTR_PER_TERM = 89.5


class BandLoop(NamedTuple):
    instr: float        # fast-path instructions a term
    lds_bytes: float    # bytes its shared-memory loads read a term


# the census of every compiled band loop (chip_smoke.py phase 2b: the
# loop of gpp_fused_kernel<2, EPT, true> and of gpp_banded_kernel<2, EPT,
# TRANSPOSED> in v6's strided and v7/v8's swapped aqsm layout; nvcc 12.9,
# sm_90a, on an NVIDIA H100 80GB HBM3; PERF.md §6), keyed (fused, aqsm
# transposed, elements a thread). A thread's EPT elements share one
# (band, iw)'s wx and their an/am loads, so LDS bytes fall with EPT
BAND_LOOP = {
    (True, True, 1): BandLoop(INSTR_PER_TERM, 12.0),
    (True, True, 2): BandLoop(88.0, 10.0),
    (True, True, 4): BandLoop(91.25, 9.0),
    (True, True, 8): BandLoop(92.625, 8.5),
    (False, False, 1): BandLoop(89.0, 12.0),
    (False, False, 2): BandLoop(88.0, 10.0),
    (False, False, 4): BandLoop(91.125, 9.0),
    (False, False, 8): BandLoop(92.875, 8.5),
    (False, True, 1): BandLoop(89.0, 12.0),
    (False, True, 2): BandLoop(88.0, 10.0),
    (False, True, 4): BandLoop(91.125, 9.0),
    (False, True, 8): BandLoop(92.625, 8.5),
}
# every one of them: FFMA 24 of its 52 FP32 arithmetic instructions a term
SASS_FMA_RATIO = 24 / 52
REG_ALLOC_UNIT = 8                     # registers are allocated in 8s


def resident_blocks(cfg: BlockConfig, spec: GpuSpec = DEFAULT_SPEC,
                    nw: int = 2) -> int:
    """Blocks of `cfg` one SM holds at once (0 = does not fit)."""
    regs = -(-cfg.regs_estimate() // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_threads = spec.max_threads_per_sm // cfg.threads
    by_regs = spec.regs_per_sm // (cfg.threads * regs)
    by_smem = spec.smem_per_sm // (cfg.smem_bytes(nw) + 1024)  # 1 KiB reserved
    return max(0, min(by_threads, by_regs, by_smem, spec.max_blocks_per_sm))


def waves(size: GppSize, cfg: BlockConfig, spec: GpuSpec = DEFAULT_SPEC
          ) -> int:
    """Whole waves of `cfg`'s blocks over the card's resident slots (0 =
    a block does not fit)."""
    slots = spec.sms * resident_blocks(cfg, spec, size.nw)
    return math.ceil(gpp_cuda.grid_blocks(size, cfg) / slots) if slots else 0


def wave_quantisation(size: GppSize, cfg: BlockConfig,
                      spec: GpuSpec = DEFAULT_SPEC) -> float:
    blocks = gpp_cuda.grid_blocks(size, cfg)
    slots = spec.sms * resident_blocks(cfg, spec, size.nw)
    if slots == 0:
        return math.inf
    return math.ceil(blocks / slots) * slots / blocks


def band_loop(cfg: BlockConfig) -> BandLoop:
    """The SASS census of the band loop `cfg` runs (BAND_LOOP)."""
    return BAND_LOOP[(cfg.fused_acc, cfg.aqsm_transposed, cfg.ept_instance())]


def instr_per_term(cfg: BlockConfig) -> float:
    """Instructions a term `step_terms` charges `cfg` for ranking:
    gpp_banded's own loop's count; gpp_fused's INSTR_PER_TERM at every
    EPT, the count its configs have always been ranked at (the journey's
    report charges each config its own loop's count, `band_loop`)."""
    return INSTR_PER_TERM if cfg.fused_acc else band_loop(cfg).instr


def issue_s(size: GppSize, cfg: BlockConfig, instr: float,
            spec: GpuSpec = DEFAULT_SPEC) -> float:
    """Seconds `size`'s terms take to issue at `instr` instructions a term
    over the card's issue rate, times `cfg`'s wave quantisation."""
    return (size.inner_iters * instr / spec.fp32_lane_ops_per_s
            * wave_quantisation(size, cfg, spec))


def step_terms(size: GppSize, cfg: BlockConfig, spec: GpuSpec = DEFAULT_SPEC):
    """(compute_s incl. wave quantisation, memory_s)."""
    compute = issue_s(size, cfg, instr_per_term(cfg), spec)
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

# Instructions one (t, c, n) element issues in csrc/ssm_scan.cu's step
# loop, by states a thread: the SASS census of ssm_scan_kernel<16, S, bf16>
# (core/sass.py loop_census; chip_smoke.py phase 2b prints it; nvcc 12.8,
# sm_90a; PERF.md), every class counted. The per-tile staging and the two
# barriers a 64-step tile are outside the loop and not counted.
SSM_INSTR_PER_ELEMENT = {2: 18.547, 4: 15.781, 8: 14.508}
# a warp's MUFU.EX2 holds its scheduler's quarter of the SM's 16 SFU lanes
# for 32 / 4 = 8 clocks; one exp an element
SSM_MUFU_CLOCKS = 8
# clocks a scheduler spends per instruction it issues from one warp alone
# and from two or more: measured, not counted (phase 7c's sweep at hymba's
# prefill on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md): ptxas's schedule
# of the unrolled steps leaves one warp stalled ~1.5 clocks an instruction
# on fixed latencies (the SASS control bits), which a second warp partly
# fills
SSM_CLOCKS_PER_INSTR = {1: 1.9, 2: 1.5}
SSM_REGS_PER_THREAD = {2: 80, 4: 80, 8: 95}   # compiled (phase 2 prints it)
SCHEDULERS_PER_SM = 4


def ssm_resident_blocks(cfg, n: int, spec: GpuSpec = DEFAULT_SPEC) -> int:
    """CTAs of `cfg` (an ssm_cuda.SsmScanConfig) one SM holds at state
    size n."""
    threads = cfg.threads(n)
    regs = -(-SSM_REGS_PER_THREAD[cfg.states] // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_threads = spec.max_threads_per_sm // threads
    by_regs = spec.regs_per_sm // (threads * regs)
    by_smem = spec.smem_per_sm // (cfg.smem_bytes(n) + 1024)
    return max(0, min(by_threads, by_regs, by_smem, spec.max_blocks_per_sm))


def ssm_step_s(key, cfg, spec: GpuSpec = DEFAULT_SPEC) -> float:
    """Modeled seconds of one ssm_scan call (key: kernel_def.SsmKey):

        max(T x the busiest scheduler's clocks a step / clock,
            bytes / HBM bandwidth)

    summed over the rounds of resident CTAs the busiest SM runs. The
    busiest SM gets ceil(CTAs / SMs) of the B x C / blk_c CTAs, `resident`
    at a time; its busiest scheduler holds w = ceil(m x warps / 4) warps of
    a round of m CTAs (warps include the padding lanes of a CTA whose
    blk_c x N / S is not a multiple of 32). Each warp issues, a step,
    S x SSM_INSTR_PER_ELEMENT[S] instructions (the census) and S MUFU.EX2
    of SSM_MUFU_CLOCKS each, so a step takes
        w x S x max(SSM_INSTR_PER_ELEMENT[S] x SSM_CLOCKS_PER_INSTR[w],
                    SSM_MUFU_CLOCKS)
    clocks. Phase 7c prints it beside the device time of every config.
    Bytes: `ssm_cuda.kernel_hbm_bytes`."""
    resident = ssm_resident_blocks(cfg, key.n, spec)
    if resident == 0:
        return math.inf
    warps = cfg.threads(key.n) // 32
    per_sm = math.ceil(key.b * (key.c // cfg.blk_c) / spec.sms)
    cycles = 0.0
    while per_sm > 0:
        m = min(resident, per_sm)
        per_sm -= m
        w = math.ceil(m * warps / SCHEDULERS_PER_SM)
        issue = (SSM_INSTR_PER_ELEMENT[cfg.states]
                 * SSM_CLOCKS_PER_INSTR[min(w, 2)])
        cycles += key.t * w * cfg.states * max(issue, SSM_MUFU_CLOCKS)
    bytes_ = ssm_cuda.kernel_hbm_bytes(key.b, key.t, key.c, key.n)
    return max(cycles / spec.boost_hz, bytes_ / spec.hbm_bw)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

# Costs of csrc/paged_decode.cu's split kernel, fitted (least squares on
# the log of the ratio) to the 75 device times of phase 12b's sweeps over
# pages_per_block and split counts at its seven qwen2-1.5b cases, on an
# NVIDIA H100 80GB HBM3 at 700 W; tools/paged_decode_probe.py --model
# holds it to shapes outside that fit (PERF.md §6). For ranking: phase
# 12b prints the modeled time beside every device time. A row tile's
# fixed path (launch, page ids and q, the first round trip, the warps'
# merge, the partials' write); a stage's wait and barrier; a warp's
# 16-line chunk of one 16-row tile at Hd 128, by pool itemsize (an int8
# chunk also widens its lines to bf16); the combine kernel, and its part for each
# split; the rate one SM's ring takes in from L2, and the card's from HBM
PAGED_FIXED_TILE_S = 3.15e-6
PAGED_STAGE_S = 0.39e-6
PAGED_CHUNK_S = {2: 0.51e-6, 1: 1.46e-6}
PAGED_COMBINE_S = 2.4e-6
PAGED_COMBINE_SPLIT_S = 0.14e-6
PAGED_SM_BW = 31.5e9
PAGED_HBM_BW = 2.5e12
# K/V that fit the 50 MB L2 stay there from call to call (graph replays
# of one call): then only the SMs' own rate bounds the loads
L2_BYTES = 50e6


def paged_terms(key, cfg, kv_itemsize: int, spec: GpuSpec = DEFAULT_SPEC,
                splits=None) -> dict:
    """The modeled parts of one paged decode call (key:
    kernel_def.PagedKey, cfg its clamped PagedBlockConfig), every row at
    its full npt pages, at `splits` (None: `paged_cuda.split_count` on
    spec's SMs, the wrapper's rule), in seconds:

      load_s     a stage's lines at the CTA's rate: PAGED_SM_BW shared by
                 the m CTAs resident together on its SM, or, when the
                 call's K/V exceed the L2, PAGED_HBM_BW shared by every
                 resident CTA if that is less
      compute_s  a stage's chunk waves (ceil(chunks / 4 warps)) x row tiles
                 x PAGED_CHUNK_S[itemsize] (a chunk at Hd 128; its products
                 scale with Hd) x m (the m CTAs share the SM's schedulers)
      cta_s      stages x (PAGED_STAGE_S + the load and the chunks: the
                 longer of the two where HBM bounds the loads and the ring
                 has two stages or more to hide the chunks, else both)
      total_s    PAGED_FIXED_TILE_S a row tile + waves x cta_s, plus the
                 combine at splits > 1 (PAGED_COMBINE_S +
                 PAGED_COMBINE_SPLIT_S a split)

    Waves: CTAs over SMs x the CTAs an SM holds (shared memory, threads)."""
    from repro_torch.kernels.paged import paged_cuda
    rows = key.h // key.kvh * key.qlen
    if splits is None:
        splits = paged_cuda.split_count(key.b, key.kvh, rows, key.npt,
                                        spec.sms)
    shape = paged_cuda.plan(rows, key.hd, key.page, key.npt,
                            cfg.pages_per_block, splits, kv_itemsize)
    if shape["stages"] == 0:
        return {"load_s": math.inf, "compute_s": math.inf,
                "cta_s": math.inf, "total_s": math.inf}
    mt, groups = paged_cuda.row_tiles(rows)
    ctas = splits * key.kvh * key.b * groups
    resident = max(1, min(spec.smem_per_sm // (shape["smem"] + 1024),
                          spec.max_threads_per_sm // (32 * paged_cuda.WARPS),
                          spec.max_blocks_per_sm))
    waves = math.ceil(ctas / (spec.sms * resident))
    together = min(resident, math.ceil(ctas / spec.sms))
    kv = 2 * key.b * key.npt * key.page * key.kvh * key.hd * kv_itemsize
    rate = PAGED_SM_BW / together
    from_hbm = (kv > L2_BYTES
                and PAGED_HBM_BW / min(ctas, spec.sms * resident) < rate)
    if from_hbm:
        rate = PAGED_HBM_BW / min(ctas, spec.sms * resident)
    sp = shape["pages_a_stage"]
    stages = math.ceil(math.ceil(key.npt / splits) / sp)
    load = 2 * sp * key.page * key.hd * kv_itemsize / rate
    waves_a_stage = math.ceil(shape["lines"] / paged_cuda.CHUNK
                              / paged_cuda.WARPS)
    compute = (waves_a_stage * mt * PAGED_CHUNK_S[kv_itemsize] * together
               * key.hd / 128)
    if from_hbm and shape["stages"] > 1:
        cta = stages * (PAGED_STAGE_S + max(load, compute))
    else:
        cta = stages * (PAGED_STAGE_S + load + compute)
    total = PAGED_FIXED_TILE_S * mt + waves * cta
    if splits > 1:
        total += PAGED_COMBINE_S + PAGED_COMBINE_SPLIT_S * splits
    return {"load_s": load, "compute_s": compute, "cta_s": cta,
            "total_s": total}


def paged_step_s(key, cfg, kv_itemsize: int,
                 spec: GpuSpec = DEFAULT_SPEC, splits=None) -> float:
    """Modeled seconds of one paged decode call (`paged_terms`'s total)."""
    return paged_terms(key, cfg, kv_itemsize, spec, splits)["total_s"]
