"""Hardware specs of the port's target cards (NVIDIA Hopper), the
counterpart of `repro.core.hw`'s TPU table.

Each spec names the part it describes, because the published tables
disagree: the H100 SXM5 data sheet gives 67 TFLOP/s FP32, 3.35 TB/s and
989 TFLOP/s dense bf16 on the tensor cores (700 W), the PCIe card 51
TFLOP/s FP32, 2.0 TB/s and 756 TFLOP/s dense bf16 (350 W; the H100 data
sheet lists 1,513 TFLOP/s bf16 with sparsity, which is twice the dense
rate). The FP32 rate is
SMs x 128 FP32 lanes x 2 (FMA) x boost clock. `spec_for_name` picks the
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


H100_SXM5 = GpuSpec(
    name="h100-sxm5", part="NVIDIA H100 SXM5 80GB (700 W)",
    sms=132, boost_hz=1.98e9, fp32_flops=67e12, hbm_bw=3.35e12,
    bf16_tc_flops=989e12)

H100_PCIE = GpuSpec(
    name="h100-pcie", part="NVIDIA H100 PCIe 80GB (350 W)",
    sms=114, boost_hz=1.755e9, fp32_flops=51e12, hbm_bw=2.0e12,
    bf16_tc_flops=756e12)

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
    """The spec of `device`'s card; the default target for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return DEFAULT_SPEC
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return spec_for_name(torch.cuda.get_device_name(index))
