"""The paper's kernel, end to end on the port: the GPP optimization
journey v0 -> v10 (v0–v8 the paper's steps, v9/v10 beyond it), each
version checked against the complex128 oracle, timed on the card and
read against its modeled Hopper roofline — Table I on an H100.

    PYTHONPATH=src python examples/gpp_science_torch.py [--size si510] \\
        [--sweep] [--tune]
    PYTHONPATH=src python examples/gpp_science_torch.py --device cpu \\
        --no-measure --sweep --tune          # the model alone, any machine

--no-measure models only (nothing runs on the device); without it every
version runs at the size on --device (the card by default; v0–v5 take
~6 s a call on an H100 at Si-214, so the run takes minutes there, and
hours on a CPU).
"""

import argparse

from repro_torch.core.journey import (format_journey, model_spec, run_journey,
                                      sweep_blocks)
from repro_torch.kernels.gpp.problem import SIZES
from repro_torch.tune import tuner

# the paper's measured speedups on the V100 (Table I): v8 over v0
PAPER_V8_SPEEDUP = {"si214": 2.36, "si510": 3.27}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="si214", choices=("si214", "si510"))
    ap.add_argument("--sweep", action="store_true",
                    help="print the v8 block-size sweep (top 10)")
    ap.add_argument("--tune", action="store_true",
                    help="print the tuner's model ranking (top 10)")
    ap.add_argument("--no-measure", action="store_true",
                    help="model only: run nothing on the device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    measure = not args.no_measure

    rows = run_journey(args.size, device=args.device, measure=measure,
                       warmup=1 if measure else 0, reps=3)
    print()
    print(format_journey(rows, args.size))

    by = {r.version: r for r in rows}
    v0, v8, v10 = by["v0"], by["v8"], by["v10"]
    print(f"\nmodeled speedup v8/v0 {v0.modeled_ms / v8.modeled_ms:.2f}x, "
          f"v10/v0 {v0.modeled_ms / v10.modeled_ms:.2f}x (the paper measured "
          f"{PAPER_V8_SPEEDUP['si214']}x at Si-214 and "
          f"{PAPER_V8_SPEEDUP['si510']}x at Si-510 for v8/v0 on a V100)")
    if measure:
        print(f"measured speedup v8/v0 {v0.ms / v8.ms:.2f}x, v10/v0 "
              f"{v0.ms / v10.ms:.2f}x [{v0.card or v0.device}]")

    spec = model_spec(args.device, measure)
    if args.sweep:
        print(f"\nv8 block sweep on {spec.part} (top 10, model):")
        for r in sweep_blocks(args.size, spec)[:10]:
            print(f"  blk=({r['blk_ig']},{r['blk_igp']},{r['blk_band']}) "
                  f"t{r['threads']} modeled={r['modeled_s'] * 1e3:.3f}ms "
                  f"tflops={r['tflops']:.2f} smem={r['smem_bytes']}B "
                  f"blocks={r['blocks']} waves={r['waves']}")

    if args.tune:
        print(f"\ntuner ranking on {spec.part} (top 10, model):")
        for cfg, t in tuner.rank(SIZES[args.size], device=spec)[:10]:
            print(f"  blk=({cfg.blk_ig},{cfg.blk_igp},{cfg.blk_band}) "
                  f"t{cfg.threads} modeled={t * 1e3:.3f}ms")


if __name__ == "__main__":
    main()
