"""The GPP optimization journey v0–v10 on the card — the port of
`repro.core.journey.run_journey`.

Per version this harness reports:
  * correctness: the version at TINY, on the same device, against the
    complex128 oracle `ref_numpy` (max-norm relative error);
  * measured time at the journey size: CUDA events on the card, median
    of `reps` after `warmup` calls (the tuner's pick for v10 is made in
    the warm-up, outside the timed calls);
  * achieved TFLOP/s under the repo's 90-FLOP-a-term count, and its share
    of the card spec's FP32 peak.

There is no modeled column: the TPU model does not describe the card and
the Hopper model (core.gpu_model) only ranks configs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch import backend
from repro_torch.core import hw
from repro_torch.kernels import api
from repro_torch.kernels.gpp import problem, ref
from repro_torch.tune import measure

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


@dataclasses.dataclass
class JourneyRow:
    version: str
    size: str
    device: str                  # backend.device_tag of the run
    rel_err: float               # at TINY vs ref_numpy
    ms: float                    # median measured time at `size`
    tflops: float                # 90 FLOP a term
    peak_share: Optional[float]  # of the card spec's FP32 peak; None on CPU
    config: Optional[dict]
    note: str = ""


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def run_journey(size_name: str = "si214", *, device=backend.DEFAULT_DEVICE,
                warmup: int = 1, reps: int = 3, versions=VERSIONS,
                verbose: bool = True) -> List[JourneyRow]:
    """Replay the paper's v0–v10 journey (Table I) on `device`: each of
    `versions` is checked against the numpy oracle at TINY and timed at
    `size_name`. Returns one JourneyRow per version.

    Example::

        import repro_torch
        rows = repro_torch.run_journey("si214")
        rows[-1].version, rows[-1].ms, rows[-1].tflops
        rows = repro_torch.run_journey("tiny", device="cpu", verbose=False)
    """
    dev = backend.resolve_device(device)
    tag = backend.device_tag(dev)
    peak = hw.spec_for_device(dev).fp32_flops if dev.type == "cuda" else None
    inputs_tiny = problem.make_inputs(problem.TINY)
    ref_tiny = ref.ref_numpy(inputs_tiny)
    size = problem.SIZES[size_name]
    t = problem.to_tensors(problem.make_inputs(size), dev)

    rows = []
    for v in versions:
        a, x = api.dispatch("gpp", inputs_tiny, version=v, device=dev)
        rel = max(_rel(a.cpu(), ref_tiny[0]), _rel(x.cpu(), ref_tiny[1]))

        secs = measure.time_callable(
            lambda: api.dispatch("gpp", t, version=v, device=dev),
            device=dev, warmup=warmup, reps=reps)
        cfg = api.resolve_config("gpp", t, version=v, device=dev)
        tflops = size.total_flops() / secs / 1e12
        rows.append(JourneyRow(
            v, size.name, tag, rel, secs * 1e3, tflops,
            tflops * 1e12 / peak if peak else None,
            dataclasses.asdict(cfg) if cfg is not None else None, NOTES[v]))
        if verbose:
            print(format_row(rows[-1]), flush=True)
    return rows


def format_row(r: JourneyRow) -> str:
    share = f"{r.peak_share:.1%}" if r.peak_share is not None else "n/a"
    cfg = ""
    if r.config:
        c = r.config
        cfg = (f" cfg=({c['blk_ig']},{c['blk_igp']},{c['blk_band']},"
               f"t{c['threads']})")
    return (f"{r.version}: {r.size} {r.ms:.3f} ms {r.tflops:.3f} TFLOP/s "
            f"({share} of FP32 peak) err@tiny={r.rel_err:.1e}{cfg} "
            f"[{r.device}] {r.note}")
