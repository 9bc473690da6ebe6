"""Tune-cache hygiene: validate / prune `kernel_tune_torch.json` entries
against the CURRENT registry — the port of `repro.tune.cache_tools`.

The cache outlives code: a kernel family can drop a version, a config
space can shrink (a shared-memory model or a compiled-instance menu
changes), a config dataclass can gain a field. A stale entry then
re-enters dispatch with a config the current code would never pick. The
auditor's CACHE001 rule reads this module's read-only half;
`python -m repro_torch.tune prune` is the repair.

An entry `kernel|dims|device tag|version -> {config: {...}}` is stale
when:

  unknown-kernel    the kernel family is no longer registered
  unknown-version   the version left the family's `versions` tuple
  malformed-key     the key does not split into 4 `|` fields, or its dims
                    do not parse (`key_from_dims`)
  bad-config        `config_from_json` cannot rebuild the config
  outside-space     the config is not in the kernel's CURRENT
                    `config_space(key, version)` (compared ignoring the
                    `name` stamp; a family without `key_from_dims` gets
                    existence-only validation)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

from repro_torch.tune import tuner


@dataclasses.dataclass(frozen=True)
class CacheIssue:
    """One stale cache entry: the key, a machine-readable reason (the
    vocabulary in the module docstring), and a human detail line."""
    key: str
    reason: str
    detail: str
    kernel: str = ""
    version: str = ""
    dims: str = ""


def _configs_equal(a, b) -> bool:
    """Config identity ignoring the `name` stamp (cached winners are
    renamed to the version; space candidates are named 'tune')."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        if "name" in {f.name for f in dataclasses.fields(a)}:
            a = dataclasses.replace(a, name="")
            b = dataclasses.replace(b, name="")
    return a == b


def validate_cache(cache_dir: Optional[str] = None) -> List[CacheIssue]:
    """Read-only check of every cache entry against the current registry:
    one `CacheIssue` per stale entry (empty = clean; a missing cache file
    is clean). Never writes the cache.

    Example::

        from repro_torch.tune.cache_tools import validate_cache
        [(i.key, i.reason) for i in validate_cache("runs/tune")]
    """
    from repro_torch.kernels import api
    issues: List[CacheIssue] = []
    for ckey, entry in sorted(tuner._load_cache(cache_dir).items()):
        parts = ckey.split("|")
        if len(parts) != 4:
            issues.append(CacheIssue(ckey, "malformed-key",
                                     f"expected 4 '|' fields, got "
                                     f"{len(parts)}"))
            continue
        kname, dims, _tag, version = parts
        where = dict(kernel=kname, version=version, dims=dims)
        try:
            k = api.get_kernel(kname)
        except KeyError:
            issues.append(CacheIssue(ckey, "unknown-kernel",
                                     f"kernel {kname!r} is not registered",
                                     **where))
            continue
        if version not in k.versions:
            issues.append(CacheIssue(ckey, "unknown-version",
                                     f"{kname} no longer has version "
                                     f"{version!r}", **where))
            continue
        try:
            cfg = k.config_from_json(dict(entry.get("config") or {}))
        except (TypeError, ValueError, KeyError) as e:
            issues.append(CacheIssue(ckey, "bad-config",
                                     f"config_from_json failed: {e}",
                                     **where))
            continue
        try:
            key = k.key_from_dims(dims)
        except NotImplementedError:
            continue          # existence-only validation for this family
        except ValueError as e:
            issues.append(CacheIssue(ckey, "malformed-key",
                                     f"key_from_dims({dims!r}) failed: {e}",
                                     **where))
            continue
        space = k.config_space(key, version)
        if space and not any(_configs_equal(cfg, c) for c in space):
            issues.append(CacheIssue(
                ckey, "outside-space",
                f"cached config {entry.get('config')} not in the current "
                f"{len(space)}-candidate space", **where))
    return issues


def prune_cache(cache_dir: Optional[str] = None, *, dry_run: bool = False
                ) -> Tuple[int, List[CacheIssue]]:
    """Drop every stale entry `validate_cache` flags and rewrite the cache
    atomically. Returns `(kept, dropped_issues)` and warns with the pruned
    keys; `dry_run=True` reports without rewriting.

    Example::

        from repro_torch.tune.cache_tools import prune_cache
        kept, dropped = prune_cache("runs/tune", dry_run=True)
    """
    issues = validate_cache(cache_dir)
    entries = tuner._load_cache(cache_dir)
    stale = {i.key for i in issues}
    kept = {k: v for k, v in entries.items() if k not in stale}
    if stale and not dry_run:
        tuner._store_cache(cache_dir, kept)
        tuner.clear_memo()      # drop in-process copies of pruned entries
    if stale:
        warnings.warn("pruned stale tune-cache entries: "
                      + ", ".join(sorted(stale)), stacklevel=2)
    return len(kept), issues
