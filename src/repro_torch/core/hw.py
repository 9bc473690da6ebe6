"""Hardware specs of the port's target cards (NVIDIA Hopper), the
counterpart of `repro.core.hw`'s TPU table.

Each spec names the part it describes, because the published tables
disagree: the H100 SXM5 data sheet gives 67 TFLOP/s FP32, 3.35 TB/s and
989 TFLOP/s dense bf16 on the tensor cores (700 W), the PCIe card 51
TFLOP/s FP32, 2.0 TB/s and 756 TFLOP/s dense bf16 (350 W; the H100 data
sheet lists 1,513 TFLOP/s bf16 with sparsity, which is twice the dense
rate). The FP32 rate is
SMs x 128 FP32 lanes x 2 (FMA) x boost clock. NVLink, the collective
term's rate: 900 GB/s on the SXM5 part, 600 GB/s on the PCIe card
through its NVLink bridge (the data sheets' figures: every link, both
directions summed). `memory_bytes`, the device memory the dry-run holds
a rank's live bytes to: 85,017,493,504 B on the SXM5 part, as an "NVIDIA
H100 80GB HBM3" reports its total_memory; the PCIe card's data sheet's
80 GB. `spec_for_name` picks the
spec from `torch.cuda.get_device_name()`. The rates assume the card's full
power limit; a card set below it runs slower under load, so every
measurement is reported beside the card's name and power limit.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    name: str
    part: str
    sms: int
    boost_hz: float
    fp32_flops: float            # FMA counted as 2 FLOP
    hbm_bw: float                # bytes/s
    bf16_tc_flops: float         # dense bf16 tensor-core peak (no sparsity)
    link_bw: float               # NVLink, bytes/s (the data sheet's total)
    memory_bytes: int            # device memory (total_memory)
    smem_per_block: int = 232_448    # opt-in dynamic shared memory a block can use
    smem_per_sm: int = 233_472       # 228 KiB of the SM's 256 KiB (rest is L1)
    regs_per_sm: int = 65_536
    regs_per_thread: int = 255
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    fp32_lanes_per_sm: int = 128

    @property
    def fp32_lane_ops_per_s(self) -> float:
        """FP32 instructions the card can issue per second (one per lane
        per cycle) — the instruction-issue roof of a kernel whose mix is
        not all FMA."""
        return self.sms * self.fp32_lanes_per_sm * self.boost_hz

    @property
    def machine_balance(self) -> float:
        """FLOP/byte at which HBM bandwidth and the bf16 tensor-core peak
        intersect: 989e12 / 3.35e12 ~= 295 on the SXM5 part (the paper
        quotes 7.4 FLOP/B for the V100 in FP64)."""
        return self.bf16_tc_flops / self.hbm_bw

    @property
    def fp32_machine_balance(self) -> float:
        """The same ridge for FP32 work outside the tensor cores (GPP's):
        67e12 / 3.35e12 = 20 FLOP/B on the SXM5 part."""
        return self.fp32_flops / self.hbm_bw


H100_SXM5 = GpuSpec(
    name="h100-sxm5", part="NVIDIA H100 SXM5 80GB (700 W)",
    sms=132, boost_hz=1.98e9, fp32_flops=67e12, hbm_bw=3.35e12,
    bf16_tc_flops=989e12, link_bw=900e9,
    # torch.cuda.get_device_properties(0).total_memory as read on an
    # "NVIDIA H100 80GB HBM3" at a 700.00 W power limit (torch 2.11, CUDA
    # 12.8)
    memory_bytes=85_017_493_504)

H100_PCIE = GpuSpec(
    name="h100-pcie", part="NVIDIA H100 PCIe 80GB (350 W)",
    sms=114, boost_hz=1.755e9, fp32_flops=51e12, hbm_bw=2.0e12,
    bf16_tc_flops=756e12, link_bw=600e9,
    memory_bytes=80 * 10 ** 9)        # the data sheet's 80 GB (not read)

SPECS = {s.name: s for s in (H100_SXM5, H100_PCIE)}

# the card the model ranks for when no card is present (CPU runs)
DEFAULT_SPEC = H100_SXM5


def spec_for_name(device_name: str) -> GpuSpec:
    """The spec for a `torch.cuda.get_device_name()` string: 'PCIe' in an
    H100's name picks the PCIe card, any other H100 the SXM5 part."""
    if "H100" not in device_name:
        raise ValueError(f"no spec for card {device_name!r}; "
                         f"known: {[s.part for s in SPECS.values()]}")
    return H100_PCIE if "PCIE" in device_name.upper() else H100_SXM5


def spec_for_device(device) -> GpuSpec:
    """The spec of `device`'s card; the default target for the CPU. A
    GpuSpec given as the device is its own spec (the auditor ranks and
    models for a spec it was handed)."""
    if isinstance(device, GpuSpec):
        return device
    dev = torch.device(device)
    if dev.type != "cuda":
        return DEFAULT_SPEC
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return spec_for_name(torch.cuda.get_device_name(index))
