"""Hierarchical roofline model on a Hopper card — the port of
`repro.core.roofline` (`RooflineReport`, `customized_ceiling`,
`analyze_counts`, `format_table`).

The paper (Yang 2020) reads one kernel against a three-level roofline
(L1/L2/HBM) and a compute ceiling customized to its FMA ratio. A report
here has the reference's three terms, on the card's rates:

  compute term     = FLOPs / customized ceiling                 (seconds)
  memory term      = HBM bytes / GpuSpec.hbm_bw
  collective term  = collective bytes / GpuSpec.link_bw (NVLink)

The dominant term is the bottleneck; the modeled time is the largest of
the three (perfect overlap; the sum is reported beside it).

Two ceilings. `customized_ceiling` is the reference's generalization to
a split of the FLOPs between two rates: dot FLOPs on bf16 or f16
operands at the tensor cores' dense rate (`GpuSpec.bf16_tc_flops`),
every other FLOP at the FP32 rate (`GpuSpec.fp32_flops`; f32 dots
included: the port keeps TF32 off, `backend.f32_accumulation`).
`fma_ceiling` is the paper's own: on the FP32 units a FLOP retired in an
FMA takes half the issue slot of any other, so a FLOP fraction f in FMAs
attains fp32_flops / (2 - f); an instruction ratio r (FFMA over FP32
arithmetic instructions, the SASS census's) is the FLOP fraction
2r / (r + 1) (`fma_flop_fraction`). The paper's 58% FMA gives 79% of the
peak (5.3 of 6.7 TFLOP/s on the V100).

Where the reference says MXU or VPU the port says tensor cores or FP32:
`tc_flops_per_chip`, `tc_fraction`, the row's `tc_frac`.

`analyze_step` is the counterpart of the reference's `analyze_compiled`
(which reads FLOPs, bytes, collectives and memory from a compiled XLA
module; the port compiles no HLO): it prices one rank's census of a
whole train, prefill or decode step (analyze.census.census_step, the
plain versions counted on fake tensors, the collectives counted by the
step's groups on an abstract mesh) on the same three terms.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch.core.hw import DEFAULT_SPEC, GpuSpec


@dataclasses.dataclass
class RooflineReport:
    name: str
    mesh_shape: tuple
    chips: int

    # raw quantities a card (a rank's program)
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    tc_flops_per_chip: float

    # derived seconds
    compute_s: float
    memory_s: float
    collective_s: float

    # ceilings
    customized_peak_flops: float   # the attainable peak of the FLOP mix
    tc_fraction: float

    # memory fit (a card, bytes)
    device_memory_bytes: Optional[int] = None

    # semantic model FLOPs (6ND convention), total across cards, a step
    model_flops_total: Optional[float] = None

    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def modeled_step_s(self) -> float:
        """Perfect-overlap model: step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def modeled_step_s_noverlap(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def roofline_fraction(self) -> float:
        """How close the modeled time is to the pure-compute bound (1.0 =
        at the roof)."""
        t = self.modeled_step_s
        return (self.compute_s / t) if t > 0 else 0.0

    @property
    def customized_fraction(self) -> float:
        """Share of the customized peak achieved at the modeled time."""
        t = self.modeled_step_s
        if t <= 0 or self.customized_peak_flops <= 0:
            return 0.0
        return (self.flops_per_chip / t) / self.customized_peak_flops

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / counted FLOPs (< 1: more FLOPs run than the math
        needs, e.g. recomputation)."""
        if self.model_flops_total is None:
            return None
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / total if total > 0 else None

    @property
    def achieved_tflops_per_chip(self) -> float:
        t = self.modeled_step_s
        return (self.flops_per_chip / t) / 1e12 if t > 0 else 0.0

    def row(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "mesh": "x".join(map(str, self.mesh_shape)),
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.modeled_step_s,
            "roofline_frac": self.roofline_fraction,
            "tc_frac": self.tc_fraction,
            "achieved_tflops_chip": self.achieved_tflops_per_chip,
            "useful_ratio": self.useful_flops_ratio,
            "hbm_gib_per_chip": (self.device_memory_bytes or 0) / 2**30,
            "model_flops": self.model_flops_total,
        }

    def to_json(self) -> str:
        return json.dumps(self.row(), default=float)


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


def fma_flop_fraction(instr_ratio: float) -> float:
    """The FLOP fraction done in FMAs, 2r / (r + 1), of an instruction
    ratio r = FFMA / (FFMA + FMUL + FADD)."""
    return 2.0 * instr_ratio / (instr_ratio + 1.0)


def fma_ceiling(fma_fraction: float, spec: GpuSpec = DEFAULT_SPEC) -> float:
    """The paper's FMA-ratio ceiling on the card's FP32 units: FLOPs in
    FMAs at `spec.fp32_flops`, the rest at half of it, so a FLOP fraction
    f in FMAs attains fp32_flops / (2 - f).

    Example::

        from repro_torch.core import roofline
        f = roofline.fma_flop_fraction(0.58)     # the paper's 58% FMA
        roofline.fma_ceiling(f) / 67e12          # 0.79
    """
    return spec.fp32_flops / (2.0 - fma_fraction)


def hierarchy(flops: float, hbm_bytes: float,
              smem_bytes: Optional[float] = None) -> Dict[str, Any]:
    """The hierarchical columns of a report's `extra`: `hbm_bytes` and
    `ai_hbm` (FLOPs a byte of HBM), `smem_bytes` and `ai_smem` (FLOPs a
    byte the shared-memory loads read; None where nothing is staged in
    shared memory)."""
    def ai(nbytes):
        return flops / nbytes if nbytes else float("inf")
    return {"hbm_bytes": hbm_bytes, "ai_hbm": ai(hbm_bytes),
            "smem_bytes": smem_bytes,
            "ai_smem": None if smem_bytes is None else ai(smem_bytes)}


def analyze_counts(
    name: str,
    *,
    flops: float,
    hbm_bytes: float,
    collective_bytes: float = 0.0,
    tc_flops: float = 0.0,
    mesh_shape: tuple = (1,),
    spec: GpuSpec = DEFAULT_SPEC,
    model_flops_total: Optional[float] = None,
    smem_bytes: Optional[float] = None,
) -> RooflineReport:
    """Roofline from counts: `flops` of which `tc_flops` on the tensor
    cores (at `customized_ceiling`), `hbm_bytes` over HBM and
    `collective_bytes` over NVLink on `spec`. `extra` holds the
    hierarchical columns (`hierarchy`); `smem_bytes` is the bytes the
    shared-memory loads read.

    Example::

        from repro_torch.core.roofline import analyze_counts
        rep = analyze_counts("x", flops=1e12, hbm_bytes=1e9)
        rep.dominant, rep.modeled_step_s        # ('compute', 0.0149...)
    """
    chips = 1
    for d in mesh_shape:
        chips *= d
    cpeak = customized_ceiling(flops, tc_flops, spec)
    extra: Dict[str, Any] = {"tc_peak_compute_s": flops / spec.bf16_tc_flops,
                             **hierarchy(flops, hbm_bytes, smem_bytes)}
    return RooflineReport(
        name=name,
        mesh_shape=tuple(mesh_shape),
        chips=chips,
        flops_per_chip=flops,
        bytes_per_chip=hbm_bytes,
        collective_bytes_per_chip=collective_bytes,
        tc_flops_per_chip=tc_flops,
        compute_s=flops / cpeak if cpeak > 0 else 0.0,
        memory_s=hbm_bytes / spec.hbm_bw,
        collective_s=collective_bytes / spec.link_bw,
        customized_peak_flops=cpeak,
        tc_fraction=(tc_flops / flops) if flops > 0 else 0.0,
        model_flops_total=model_flops_total,
        extra=extra,
    )


def analyze_step(name: str, census, *, spec: GpuSpec = DEFAULT_SPEC,
                 model_flops_total: Optional[float] = None
                 ) -> RooflineReport:
    """Roofline of one rank's step census (analyze.census.StepCensus):
    compute at `customized_ceiling` of its `flops` and `tc_flops`, memory
    as its `op_bytes` (every dispatched op's inputs and outputs) over
    `spec.hbm_bw`, collectives as the bytes the rank hands its groups
    over `spec.link_bw`, `device_memory_bytes` its high-water mark of
    live bytes, `model_flops_total` as given (every rank's). `extra`
    holds the collectives by kind (bytes and counts, every group
    together, as the reference's), by group, the launches and the state
    bytes. The seconds are modeled on `spec`'s rates, not measured.

    Example::

        from repro_torch.core.roofline import analyze_step
        rep = analyze_step("qwen2-1.5b/decode_32k", census)
        rep.dominant, rep.modeled_step_s
    """
    by_kind: Dict[str, int] = {}
    count_by_kind: Dict[str, int] = {}
    for group in census.collectives.values():
        for kind, n in group["bytes"].items():
            by_kind[kind] = by_kind.get(kind, 0) + n
        for kind, n in group["calls"].items():
            count_by_kind[kind] = count_by_kind.get(kind, 0) + n
    mesh_shape = tuple(census.mesh_shape.values()) or (1,)
    rep = analyze_counts(name, flops=census.flops,
                         hbm_bytes=census.op_bytes,
                         collective_bytes=float(sum(by_kind.values())),
                         tc_flops=census.tc_flops, mesh_shape=mesh_shape,
                         spec=spec, model_flops_total=model_flops_total)
    rep.device_memory_bytes = int(census.peak_live_bytes)
    rep.extra.update(collective_bytes_by_kind=by_kind,
                     collective_count_by_kind=count_by_kind,
                     collectives_by_group=census.collectives,
                     launches=census.launches,
                     state_bytes=census.state_bytes, spec=spec.name)
    return rep


def format_table(reports) -> str:
    """Markdown table of roofline rows."""
    cols = [
        ("cell", "name", "{}"),
        ("mesh", "mesh", "{}"),
        ("compute_s", "compute_s", "{:.4g}"),
        ("memory_s", "memory_s", "{:.4g}"),
        ("collective_s", "collective_s", "{:.4g}"),
        ("dominant", "dominant", "{}"),
        ("step_s", "step_s", "{:.4g}"),
        ("roofline", "roofline_frac", "{:.2%}"),
        ("tc%", "tc_frac", "{:.1%}"),
        ("TF/chip", "achieved_tflops_chip", "{:.1f}"),
        ("useful", "useful_ratio", "{}"),
        ("GiB/chip", "hbm_gib_per_chip", "{:.2f}"),
    ]
    lines = ["| " + " | ".join(c[0] for c in cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in reports:
        row = r.row()
        vals = []
        for _, key, fmt in cols:
            v = row.get(key)
            if v is None:
                vals.append("—")
            elif key == "useful_ratio":
                vals.append(f"{v:.2f}")
            else:
                vals.append(fmt.format(v))
        lines.append("| " + " | ".join(vals) + " |")
    return "\n".join(lines)
