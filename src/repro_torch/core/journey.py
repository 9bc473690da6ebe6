"""The GPP optimization journey v0–v10 on the card — the port of
`repro.core.journey` (`run_journey`, `sweep_blocks`, `format_journey`).

Per version this harness reports:
  * correctness: the version at TINY, on the same device, against the
    complex128 oracle `ref_numpy` (max-norm relative error);
  * measured time at the journey size: CUDA events on the card, median
    of `reps` after `warmup` calls (the tuner's pick for v10 is made in
    the warm-up, outside the timed calls);
  * achieved TFLOP/s under the repo's 90-FLOP-a-term count, and its share
    of the card spec's FP32 peak;
  * the modeled Hopper roofline (`_model_report`, a
    `roofline.RooflineReport` on the card's spec): the larger of a
    compute and a memory term, the paper's FMA-ratio ceiling and the
    hierarchical columns `ai_hbm` and `ai_smem`. For v6–v10 each term is
    a bound (counted instructions, compulsory traffic), so a measured time
    under the modeled one is a fault in the count. For v0–v5 the memory
    term charges every op's bytes to HBM and is not a strict bound: the
    50 MB L2 can serve an op's inputs that the op before it wrote.

`run_journey(..., measure=False)` models only: nothing runs, `ms` and
`rel_err` are None. `sweep_blocks` is the paper's v8 step on the card
(gpp_banded's feasible configs under the model); `format_journey` gives
Table I.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core import gpu_model, hw, roofline
from repro_torch.kernels import api
from repro_torch.kernels.gpp import gpp_cuda, problem, ref
from repro_torch.tune import space, tuner
from repro_torch.tune.measure import time_callable

VERSIONS = ("v0", "v1", "v2", "v3", "v4", "v5", "v6", "v7", "v8", "v9",
            "v10")

NOTES = {
    "v0": "baseline: divides, abs(), 3-way branch, igp-stream",
    "v1": "divides -> reciprocals",
    "v2": "3-way branch -> masked selects",
    "v3": "abs() -> squared-magnitude compares",
    "v4": "serialize band",
    "v5": "hoist mat across iw",
    "v6": "gpp_banded, small band blocks, aqsm read strided (igp, band)",
    "v7": "aqsm index swap (band, igp): coalesced",
    "v8": "block-size tuning",
    "v9": "gpp_fused: one partial per tile, wtilde/eps read once",
    "v10": "v9 under the tuner's pick, measured on the card",
}

# the size the plain versions v0–v5 are censused at, and the loop each
# one's launches repeat over: v0–v3 stream over igp, v4/v5 over bands, so
# their launches scale with that dim while FLOPs and bytes scale per term
CENSUS_SIZE = problem.BENCH
_LAUNCH_LOOP = {"v0": "ngpown", "v1": "ngpown", "v2": "ngpown",
                "v3": "ngpown", "v4": "nbands", "v5": "nbands"}


@dataclasses.dataclass
class JourneyRow:
    version: str
    size: str
    device: str                  # backend.device_tag of the run ("model")
    rel_err: Optional[float]     # at TINY vs ref_numpy; None unmeasured
    ms: Optional[float]          # median measured time at `size`
    tflops: Optional[float]      # 90 FLOP a term, measured
    peak_share: Optional[float]  # of the card spec's FP32 peak; None on CPU
    config: Optional[dict]
    report: roofline.RooflineReport
    note: str = ""
    card: Optional[str] = None   # nvidia-smi's name and power limit

    @property
    def modeled_ms(self) -> float:
        return self.report.modeled_step_s * 1e3

    @property
    def modeled_tflops(self) -> float:
        t = self.report.modeled_step_s
        return (self.report.flops_per_chip / t / 1e12) if t else 0.0

    @property
    def measured_over_modeled(self) -> Optional[float]:
        return None if self.ms is None else self.ms / self.modeled_ms


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


@functools.lru_cache(maxsize=None)
def _plain_census(version: str, size: problem.GppSize):
    """The census of plain `version` at `size` on fake tensors
    (analyze.census; the counts do not depend on the spec)."""
    from repro_torch.analyze.census import census_kernel
    return census_kernel("gpp", version, size, device="cpu")


def _version_config(version: str, size: problem.GppSize,
                    spec: hw.GpuSpec) -> gpp_cuda.BlockConfig:
    """The BlockConfig a kernel version runs under at `size`: static for
    v6–v9, the tuner's model-ranked first for v10 (as the JAX journey
    does)."""
    if version == "v10":
        cfg = tuner.rank(size, version="v10", device=spec)[0][0]
        return dataclasses.replace(cfg, name="v10")
    return gpp_cuda.CONFIGS[version].clamped(size)


def _model_report(version: str, size: problem.GppSize,
                  spec: hw.GpuSpec = hw.DEFAULT_SPEC,
                  config: Optional[gpp_cuda.BlockConfig] = None
                  ) -> roofline.RooflineReport:
    """The modeled Hopper roofline of `version` at `size` on `spec`.

    flops_per_chip is the repo's 90 FLOP a term for every version (the
    count of every TFLOP/s column). The terms:

      v0–v5 (plain torch, each aten op a kernel): the census of the plain
        version at CENSUS_SIZE on fake tensors (analyze.census), its
        counts scaled per term (inner_iters) to `size`.
          compute  the census FLOPs over `roofline.fma_ceiling` of the
                   census's `fma_fraction`
          memory   `op_bytes` (every op's inputs and outputs) over HBM
          extra    the launches (scaled by the loop they repeat over,
                   `_LAUNCH_LOOP`); no shared memory, so ai_smem is None
      v6–v10 (gpp_banded, gpp_fused) under `config` (default: the
        version's, v10's the tuner's model-ranked first):
          compute  the issue term (`gpu_model.issue_s`): the config's
                   own SASS band-loop instructions a term
                   (`gpu_model.band_loop`, the BAND_LOOP table
                   chip_smoke.py phase 2b holds to the built library)
                   over the card's issue rate, times the wave
                   quantisation. The tuner ranks gpp_fused at
                   INSTR_PER_TERM for every EPT; the report does not
          memory   `gpp_cuda.hbm_traffic_model` over HBM
          ceiling  `roofline.fma_ceiling` of the SASS FMA ratio
          ai_smem  FLOPs over the bytes the band loop's LDS read a term

    ai_hbm is the FLOPs over the modeled HBM bytes (`roofline.hierarchy`).
    No TPU constant and no `vpu_model` enters."""
    flops = size.total_flops()
    extra: Dict = {}
    if version in _LAUNCH_LOOP:
        c = _plain_census(version, CENSUS_SIZE)
        scale = size.inner_iters / CENSUS_SIZE.inner_iters
        loop = _LAUNCH_LOOP[version]
        census_flops = c.flops * scale
        ceiling = roofline.fma_ceiling(c.fma_fraction, spec)
        hbm = c.op_bytes * scale
        compute_s = census_flops / ceiling
        smem = None
        extra.update({
            "source": f"census of the plain version at {CENSUS_SIZE.name}, "
                      "scaled per term",
            "census_flops": census_flops, "fma_fraction": c.fma_fraction,
            "launches": round(c.launches * getattr(size, loop)
                              / getattr(CENSUS_SIZE, loop))})
    else:
        cfg = config if config is not None else _version_config(
            version, size, spec)
        band_loop = gpu_model.band_loop(cfg)
        compute_s = gpu_model.issue_s(size, cfg, band_loop.instr, spec)
        hbm = gpp_cuda.hbm_traffic_model(size, cfg)
        ceiling = roofline.fma_ceiling(
            roofline.fma_flop_fraction(gpu_model.SASS_FMA_RATIO), spec)
        smem = size.inner_iters * band_loop.lds_bytes
        blocks = gpp_cuda.grid_blocks(size, cfg)
        extra.update({
            "source": "SASS census of the band loop (gpu_model.BAND_LOOP) "
                      "and gpp_cuda.hbm_traffic_model",
            "block_config": (cfg.blk_ig, cfg.blk_igp, cfg.blk_band,
                             cfg.threads),
            "instr_per_term": band_loop.instr,
            "sass_fma_ratio": gpu_model.SASS_FMA_RATIO,
            "blocks": blocks,
            "waves": gpu_model.waves(size, cfg, spec)})
    extra.update({"fp32_peak": spec.fp32_flops,
                  **roofline.hierarchy(flops, hbm, smem)})
    return roofline.RooflineReport(
        name=f"gpp-{version}-{size.name}",
        mesh_shape=(1,),
        chips=1,
        flops_per_chip=flops,
        bytes_per_chip=hbm,
        collective_bytes_per_chip=0.0,
        tc_flops_per_chip=0.0,
        compute_s=compute_s,
        memory_s=hbm / spec.hbm_bw,
        collective_s=0.0,
        customized_peak_flops=ceiling,
        tc_fraction=0.0,
        extra=extra,
    )


def card_name(device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them (None
    for the CPU or without nvidia-smi)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def model_spec(device, measure: bool = True) -> hw.GpuSpec:
    """The card the rows are modeled for: the device's; a model-only run
    asked for the card on a machine without one models the default
    target."""
    if measure or torch.device(device).type != "cuda" \
            or torch.cuda.is_available():
        return hw.spec_for_device(device)
    return hw.DEFAULT_SPEC


def run_journey(size_name: str = "si214", *, device=backend.DEFAULT_DEVICE,
                warmup: int = 1, reps: int = 3, versions=VERSIONS,
                measure: bool = True, verbose: bool = True
                ) -> List[JourneyRow]:
    """Replay the paper's v0–v10 journey (Table I) on `device`: each of
    `versions` is checked against the numpy oracle at TINY, timed at
    `size_name` and modeled on the device's card (`_model_report`).
    measure=False models only (nothing runs; ms and rel_err are None).
    Returns one JourneyRow per version.

    Example::

        import repro_torch
        rows = repro_torch.run_journey("si214")
        rows[-1].ms, rows[-1].modeled_ms, rows[-1].measured_over_modeled
        rows = repro_torch.run_journey("si214", measure=False, verbose=False)
    """
    size = problem.SIZES[size_name]
    spec = model_spec(device, measure)
    if measure:
        dev = backend.resolve_device(device)
        tag, card = backend.device_tag(dev), card_name(dev)
        inputs_tiny = problem.make_inputs(problem.TINY)
        ref_tiny = ref.ref_numpy(inputs_tiny)
        t = problem.to_tensors(problem.make_inputs(size), dev)
    else:
        tag, card = "model", None

    rows = []
    for v in versions:
        rel = secs = cfg = tflops = share = None
        if measure:
            a, x = api.dispatch("gpp", inputs_tiny, version=v, device=dev)
            rel = max(_rel(a.cpu(), ref_tiny[0]), _rel(x.cpu(), ref_tiny[1]))
            secs = time_callable(
                lambda: api.dispatch("gpp", t, version=v, device=dev),
                device=dev, warmup=warmup, reps=reps)
            cfg = api.resolve_config("gpp", t, version=v, device=dev)
            tflops = size.total_flops() / secs / 1e12
            if dev.type == "cuda":
                share = tflops * 1e12 / spec.fp32_flops
        if cfg is None and v not in _LAUNCH_LOOP:
            cfg = _version_config(v, size, spec)
        rep = _model_report(v, size, spec, cfg)
        rows.append(JourneyRow(
            v, size.name, tag, rel, None if secs is None else secs * 1e3,
            tflops, share, dataclasses.asdict(cfg) if cfg else None, rep,
            NOTES[v], card))
        if verbose:
            print(format_row(rows[-1]), flush=True)
    return rows


def sweep_blocks(size_name: str = "si214",
                 spec: hw.GpuSpec = hw.DEFAULT_SPEC) -> List[Dict]:
    """v8's step on the card: gpp_banded's candidate configs at
    `size_name` (`tune.space.candidates`, aqsm swapped) that launch on
    `spec` (shared memory within a block's, at least one block resident
    on an SM; the candidates' blocks tile the problem), each modeled by
    `gpu_model.step_s`; sorted by modeled time. Superseded by
    repro_torch.tune, kept as the paper-step artifact.

    Example::

        from repro_torch.core.journey import sweep_blocks
        best = sweep_blocks("si214")[0]
        best["blk_ig"], best["blk_igp"], best["blk_band"], best["modeled_s"]
    """
    size = problem.SIZES[size_name]
    out = []
    for cfg in space.candidates(size, fused=False, aqsm_transposed=True):
        if (cfg.smem_bytes(size.nw) > spec.smem_per_block
                or gpu_model.resident_blocks(cfg, spec, size.nw) == 0):
            continue
        t = gpu_model.step_s(size, cfg, spec)
        out.append({"blk_ig": cfg.blk_ig, "blk_igp": cfg.blk_igp,
                    "blk_band": cfg.blk_band, "threads": cfg.threads,
                    "smem_bytes": cfg.smem_bytes(size.nw),
                    "hbm_bytes": gpp_cuda.hbm_traffic_model(size, cfg),
                    "blocks": gpp_cuda.grid_blocks(size, cfg),
                    "waves": gpu_model.waves(size, cfg, spec),
                    "modeled_s": t,
                    "tflops": size.total_flops() / t / 1e12})
    return sorted(out, key=lambda r: r["modeled_s"])


def _pct(x: Optional[float]) -> str:
    return "—" if x is None else f"{x:.1%}"


def format_row(r: JourneyRow) -> str:
    share = f"{r.peak_share:.1%}" if r.peak_share is not None else "n/a"
    cfg = ""
    if r.config:
        c = r.config
        cfg = (f" cfg=({c['blk_ig']},{c['blk_igp']},{c['blk_band']},"
               f"t{c['threads']})")
    measured = ("not measured" if r.ms is None else
                f"{r.ms:.3f} ms {r.tflops:.3f} TFLOP/s ({share} of FP32 "
                f"peak) err@tiny={r.rel_err:.1e}")
    ratio = r.measured_over_modeled
    return (f"{r.version}: {r.size} {measured}; modeled {r.modeled_ms:.3f} "
            f"ms ({r.report.dominant}"
            f"{'' if ratio is None else f', measured/modeled {ratio:.3f}'})"
            f"{cfg} [{r.device}] {r.note}")


def format_journey(rows: List[JourneyRow], size_name: str) -> str:
    """Table I in markdown: measured and modeled ms, their ratio, the
    dominant term, the share of the FP32 peak and of the FMA-ratio
    (customized) ceiling (of the measured TFLOP/s where a row was
    measured, else of the modeled), ai_hbm and ai_smem. The title names
    the card and its power limit where rows were measured."""
    ran = sorted({r.card or r.device for r in rows if r.ms is not None})
    where = (f"measured on {', '.join(ran)}" if ran else
             "modeled only, not measured")
    lines = [
        f"GPP journey — {size_name} ({where}; modeled on the Hopper "
        "roofline, 90 FLOP a term)",
        "| ver | measured ms | modeled ms | measured/modeled | dominant | "
        "%FP32 peak | %customized | ai_hbm | ai_smem | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rep = r.report
        tf = r.tflops if r.tflops is not None else r.modeled_tflops
        ratio = r.measured_over_modeled
        smem = rep.extra.get("ai_smem")
        lines.append(
            f"| {r.version} | {'—' if r.ms is None else f'{r.ms:.3f}'} "
            f"| {r.modeled_ms:.3f} "
            f"| {'—' if ratio is None else f'{ratio:.3f}'} "
            f"| {rep.dominant} | {_pct(tf * 1e12 / rep.extra['fp32_peak'])} "
            f"| {_pct(tf * 1e12 / rep.customized_peak_flops)} "
            f"| {rep.extra['ai_hbm']:.3g} "
            f"| {'—' if smem is None else f'{smem:.3g}'} | {r.note} |")
    return "\n".join(lines)

