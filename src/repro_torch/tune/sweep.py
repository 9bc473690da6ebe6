"""Time every candidate of the GPP tuner's config space on the card and
hold the measured order against the ranking model's (core.gpu_model).

    PYTHONPATH=src python -m repro_torch.tune.sweep [--size si214]
        [--reps 3] [--top-k 6] [--out chiprun_out/sweep.jsonl]

Writes one JSON line per candidate to --out: its blocks, its measured ms
(CUDA events, median of --reps after one warm-up), its modeled ms and its
rank under the model. Prints a summary: the measured best and its model
rank, the static v9 config's time, and whether the tuner's timed set (the
model's --top-k plus the static config) holds a config within 1% of the
measured best. Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch import backend
from repro_torch.kernels import api
from repro_torch.kernels.gpp import problem
from repro_torch.tune import measure, tuner


def _blocks(cfg) -> str:
    return f"({cfg.blk_ig},{cfg.blk_igp},{cfg.blk_band},t{cfg.threads})"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="si214", choices=sorted(problem.SIZES))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top-k", type=int, default=6)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sweep.jsonl"))
    args = ap.parse_args(argv)

    dev = backend.resolve_device("cuda")
    size = problem.SIZES[args.size]
    k = api.get_kernel("gpp")
    ranked = tuner.rank_kernel("gpp", size, device=dev)
    (t,), _ = k.make_example(size, device=dev)
    static = k.finalize_config(k.static_config(size, "v10"), "v10")

    rows = []
    for rank, (cfg, model_s) in enumerate(ranked):
        s = measure.time_callable(
            lambda cfg=cfg: k.run(t, version="v10", config=cfg, device=dev),
            device=dev, warmup=1, reps=args.reps)
        rows.append({"blocks": _blocks(cfg), "config": dataclasses.asdict(cfg),
                     "ms": s * 1e3, "model_ms": model_s * 1e3,
                     "model_rank": rank,
                     "static": k.finalize_config(cfg, "v10") == static})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")

    best = min(rows, key=lambda r: r["ms"])
    near = {r["model_rank"] for r in rows if r["ms"] <= best["ms"] * 1.01}
    st = [r for r in rows if r["static"]]
    timed = set(range(args.top_k)) | {r["model_rank"] for r in st}
    print(json.dumps({
        "size": size.name, "candidates": len(rows),
        "best": best["blocks"], "best_ms": best["ms"],
        "best_model_rank": best["model_rank"],
        "within_1pct": len(near),
        "static_ms": st[0]["ms"] if st else None,
        "static_model_rank": st[0]["model_rank"] if st else None,
        "timed_set_best_ms": min(rows[i]["ms"] for i in timed),
        "timed_set_has_near_best": bool(timed & near),
        "model_top": [r["blocks"] + f" {r['ms']:.3f}" for r in rows[:args.top_k]],
        "fastest": [r["blocks"] + f" {r['ms']:.3f}"
                    for r in sorted(rows, key=lambda r: r["ms"])[:10]],
    }), flush=True)


if __name__ == "__main__":
    main()
