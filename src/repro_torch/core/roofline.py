"""The roofline's customized ceiling on a Hopper card — the part of
`repro.core.roofline` (:135-146) the static auditor needs.

The paper customizes the V100's peak to its kernel's FMA ratio (58% FMA
=> (2 x .58 + .42) / 2 = 79% of 6.7 TF = 5.3 TF). The JAX package
generalizes that to the TPU's MXU/VPU split; here the split is the
H100's: dot FLOPs on bf16 or f16 operands run at the tensor cores'
dense rate (`GpuSpec.bf16_tc_flops`), every other FLOP at the FP32 rate
(`GpuSpec.fp32_flops`). That includes f32 dots: the port keeps TF32 off
(`backend.f32_accumulation`), so an f32 product is FP32 arithmetic.
"""

from __future__ import annotations

from repro_torch.core.hw import DEFAULT_SPEC, GpuSpec


def customized_ceiling(total_flops: float, tc_flops: float,
                       spec: GpuSpec = DEFAULT_SPEC) -> float:
    """Attainable FLOP/s for `total_flops` of which `tc_flops` run on the
    tensor cores: the time-weighted mix of the two rates.

    Example::

        from repro_torch.core.roofline import customized_ceiling
        customized_ceiling(1e9, 0.0)      # 67e12: all FP32
        customized_ceiling(1e9, 1e9)      # 989e12: all on the tensor cores
    """
    total_flops = max(total_flops, 1.0)
    tc = min(tc_flops, total_flops)
    t = tc / spec.bf16_tc_flops + (total_flops - tc) / spec.fp32_flops
    return total_flops / t
