"""Candidate space for the GPP block-size tuner on Hopper — the port of
`repro.tune.space`.

A candidate must (a) exactly tile every axis it blocks (the launcher
checks divisibility), (b) give every thread at least one element and at
most 8 (the compiled instances), and (c) fit a Hopper block: shared
memory ≤ 232,448 B, ≤ 255 registers a thread and one block's registers
within a SM's 65,536. The TPU's
16 MiB VMEM budget has no counterpart. blk_igp starts at 32 so that a
warp reads one contiguous row of wtilde/eps.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.kernels.gpp.gpp_cuda import (
    EPT_INSTANCES, REGS_PER_SM, REGS_PER_THREAD, SMEM_PER_BLOCK, BlockConfig)
from repro_torch.kernels.gpp.problem import GppSize

IG_MENU = (8, 16, 32, 64, 128, 256)
IGP_MENU = (32, 64, 128, 256)
BAND_MENU = (8, 16, 32, 64, 128)
THREADS_MENU = (128, 256, 512)


def _divisors(n: int, menu: Sequence[int]) -> List[int]:
    return [b for b in menu if b <= n and n % b == 0]


def feasible(cfg: BlockConfig, nw: int = 2) -> bool:
    """Whether `cfg` launches on Hopper: whole warps, no idle thread, a
    compiled elements-per-thread instance, shared memory and registers
    within a block's limits."""
    return (cfg.threads % 32 == 0
            and cfg.blk_ig * cfg.blk_igp >= cfg.threads
            and cfg.ept_instance() <= max(EPT_INSTANCES)
            and cfg.smem_bytes(nw) <= SMEM_PER_BLOCK
            and cfg.regs_estimate() <= REGS_PER_THREAD
            and cfg.regs_estimate() * cfg.threads <= REGS_PER_SM)


def candidates(size: GppSize, *, fused: bool = True,
               aqsm_transposed: bool = True) -> List[BlockConfig]:
    """All feasible BlockConfigs for `size`. Deterministic (menu) order."""
    out = []
    for big in _divisors(size.ncouls, IG_MENU):
        for bigp in _divisors(size.ngpown, IGP_MENU):
            for bb in _divisors(size.nbands, BAND_MENU):
                for threads in THREADS_MENU:
                    cfg = BlockConfig("tune", big, bigp, bb,
                                      aqsm_transposed=aqsm_transposed,
                                      fused_acc=fused, threads=threads)
                    if feasible(cfg, size.nw):
                        out.append(cfg)
    return out
