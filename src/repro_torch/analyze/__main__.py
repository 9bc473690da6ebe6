"""Static kernel auditor CLI — the port of `python -m repro.analyze`.

    python -m repro_torch.analyze [--strict] [--json OUT] [--kernel NAME ...]
                                  [--cache-dir DIR] [--no-cache]
                                  [--extra-module MOD ...]
                                  [--device cuda|cpu]

Censuses every registered `(kernel, version, canonical shape)` on fake
tensors (no kernel runs) and runs the rules (SMEM001, BLK001, DTYPE001,
DUP001, CACHE001, MODEL001, KV001) against the card's spec: by default
the card of `--device cuda` (`hw.spec_for_device`), where each census
also reads the library's own shared memory of its launch; with no card
that fails, and `--device cpu` audits against `hw.DEFAULT_SPEC`.
`--strict` exits 1 on any error-severity finding; `--json` writes the
full `repro_torch-analyze/v1` report. `--extra-module` imports modules
first, so out-of-tree kernels can register themselves.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from repro_torch import backend
from repro_torch.analyze import rules
from repro_torch.core import hw


def _fmt_si(x: float) -> str:
    for div, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if x >= div:
            return f"{x / div:.2f}{suffix}"
    return f"{x:.0f}"


def _print_report(report: rules.AuditReport) -> None:
    hdr = (f"{'kernel':12s} {'version':8s} {'shape':22s} {'flops':>8s} "
           f"{'fma%':>5s} {'AI':>7s} {'smem':>9s} {'grid':>5s} "
           f"{'model_s':>9s} {'bound_s':>9s}")
    print(hdr)
    print("-" * len(hdr))
    for c in report.censuses:
        smem = c.smem_config_bytes
        print(f"{c.kernel:12s} {c.version:8s} {c.key_dims:22s} "
              f"{_fmt_si(c.flops):>8s} {100 * c.fma_fraction:4.0f}% "
              f"{c.arithmetic_intensity:7.1f} "
              f"{_fmt_si(smem) + 'B' if smem else '-':>9s} "
              f"{c.grid_blocks if c.grid_blocks is not None else '-':>5} "
              f"{c.model_s if c.model_s is not None else float('nan'):9.3g} "
              f"{c.bound_s:9.3g}")
    print()
    for f in report.findings:
        print(f"[{f.severity.upper():7s}] {f.rule} "
              f"{f.kernel}/{f.version}@{f.key_dims}: {f.message}")
    print(f"{len(report.censuses)} censuses on {report.spec}, "
          f"{len(report.errors)} errors, {len(report.warnings)} warnings")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analyze",
                                description=__doc__.splitlines()[0])
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any error-severity finding")
    p.add_argument("--json", metavar="OUT", default=None,
                   help="write the repro_torch-analyze/v1 JSON report here")
    p.add_argument("--kernel", action="append", default=None,
                   help="audit only this family (repeatable; default all)")
    p.add_argument("--cache-dir", default=None,
                   help="tune cache for CACHE001 (default: "
                        "$REPRO_TUNE_CACHE or runs/tune)")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the CACHE001 tune-cache audit")
    p.add_argument("--extra-module", action="append", default=[],
                   help="import this module before auditing (registers "
                        "out-of-tree kernels; repeatable)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="audit against this card's spec (cuda, the "
                        "default; fails without a card) or against "
                        "hw.DEFAULT_SPEC (cpu)")
    args = p.parse_args(argv)

    device = backend.resolve_device(args.device)
    for mod in args.extra_module:
        importlib.import_module(mod)

    report = rules.audit_registry(args.kernel, cache_dir=args.cache_dir,
                                  spec=hw.spec_for_device(device),
                                  skip_cache=args.no_cache, device=device)
    _print_report(report)

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report.to_json(), fh, indent=1, sort_keys=True)
        print(f"wrote {args.json}")

    if args.strict and report.errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
