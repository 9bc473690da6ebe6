"""Tune-cache hygiene CLI — the port of `python -m repro.tune`.

    python -m repro_torch.tune validate [--cache-dir DIR]   # exit 1 if stale
    python -m repro_torch.tune prune    [--cache-dir DIR] [--dry-run]

`validate` is read-only (the auditor's CACHE001 calls the same code);
`prune` rewrites the cache atomically with the stale entries dropped.
Neither needs a card.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.tune import cache_tools, tuner


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("validate", "prune"):
        sp = sub.add_parser(name)
        sp.add_argument("--cache-dir", default=None,
                        help=f"cache directory (default: ${tuner.CACHE_ENV} "
                             "or runs/tune)")
        if name == "prune":
            sp.add_argument("--dry-run", action="store_true",
                            help="report what would be pruned, keep cache")
    args = p.parse_args(argv)

    path = tuner._cache_path(args.cache_dir)
    if args.cmd == "validate":
        issues = cache_tools.validate_cache(args.cache_dir)
        for i in issues:
            print(f"STALE {i.key}: [{i.reason}] {i.detail}")
        n = len(tuner._load_cache(args.cache_dir))
        print(f"{path}: {n} entries, {len(issues)} stale")
        return 1 if issues else 0

    kept, issues = cache_tools.prune_cache(args.cache_dir,
                                           dry_run=args.dry_run)
    verb = "would prune" if args.dry_run else "pruned"
    for i in issues:
        print(f"{verb} {i.key}: [{i.reason}] {i.detail}")
    print(f"{path}: kept {kept}, {verb} {len(issues)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
