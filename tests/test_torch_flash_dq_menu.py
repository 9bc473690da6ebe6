"""flash_bwd_dq's block menu and its shared-memory and register models
(repro_torch.kernels.flash.flash_cuda), which the wrapper's checks and the
backward's default blocks read: one warpgroup a CTA over 64 query rows,
kv blocks of 64 or 128 rows in a 2-stage TMA ring, two CTAs an SM where
shared memory and registers allow. The compiled counts come from the card
(chip_smoke.py phase 2 prints them beside DQ_REGS_BY_INSTANCE)."""

import pytest

from repro_torch.core import hw
from repro_torch.kernels.flash import flash_cuda


def test_menu_and_default_blocks():
    assert flash_cuda.DQ_BLK_Q == 64 and flash_cuda.DQ_THREADS == 128
    assert flash_cuda.DQ_BLK_KV_INSTANCES == (64, 128)
    assert (flash_cuda.DQ_BLOCKS.blk_q, flash_cuda.DQ_BLOCKS.blk_kv) == (64, 64)
    for s in (512, 4096):
        dq, dkv = flash_cuda.bwd_configs(s, s)
        assert (dq.blk_q, dq.blk_kv) == (64, 64)
        assert (dkv.blk_q, dkv.blk_kv) == (64, flash_cuda.DKV_BLK_KV)
    # every compiled instance has a register count, within a thread's 255
    assert set(flash_cuda.DQ_REGS_BY_INSTANCE) == {
        (hd, kv) for hd in flash_cuda.HD_INSTANCES
        for kv in flash_cuda.DQ_BLK_KV_INSTANCES}
    assert all(r <= 255 for r in flash_cuda.DQ_REGS_BY_INSTANCE.values())


@pytest.mark.parametrize("hd,blk_kv,smem", [
    (64, 64, 2 * 64 * 64 * 2 + 2 * 2 * 64 * 64 * 2),
    (64, 128, 2 * 64 * 64 * 2 + 2 * 2 * 128 * 64 * 2),
    (128, 64, 2 * 64 * 128 * 2 + 2 * 2 * 64 * 128 * 2),
    (128, 128, 2 * 64 * 128 * 2 + 2 * 2 * 128 * 128 * 2)])
def test_shared_memory_model(hd, blk_kv, smem):
    """q + dout tiles, 2 stages of K + V, bf16; lse and delta rows (2 x 64
    f32); 64 B of mbarriers; 1 KiB to align the swizzled tiles."""
    assert flash_cuda.dq_smem_bytes(hd, blk_kv) == smem + 512 + 64 + 1024
    assert flash_cuda.dq_smem_bytes(hd, blk_kv) <= flash_cuda.SMEM_PER_BLOCK


@pytest.mark.parametrize("hd,blk_kv,ctas", [(64, 64, 2), (64, 128, 2),
                                            (128, 64, 2), (128, 128, 1)])
def test_resident_ctas(hd, blk_kv, ctas):
    """Two CTAs an SM (the launch bounds) unless shared memory holds one:
    at Hd 128 with 128-row kv blocks a CTA takes 161 KiB."""
    assert flash_cuda.dq_resident_ctas(hd, blk_kv) == ctas
    assert flash_cuda.dq_resident_ctas(hd, blk_kv, hw.H100_PCIE) == ctas
