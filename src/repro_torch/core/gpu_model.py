"""Hopper ranking model for the GPP kernels — the tuner's ranking
function, the counterpart of `repro.core.vpu_model` (which models the
TPU's VPU passes, lane fill and grid overhead, none of which a GPU has).

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
from repro_torch.kernels.gpp import gpp_cuda
from repro_torch.kernels.gpp.gpp_cuda import BlockConfig
from repro_torch.kernels.gpp.problem import GppSize

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
