"""repro_torch.analyze: the registry-wide static kernel auditor — the
port of `repro.analyze`.

Every one of the paper's 8 steps starts from a census and a roofline
position. This package is that discipline as a gate: it censuses every
registered `(kernel, version, canonical shape)` by running the version's
plain version on fake tensors (no data, nothing computed), reads the
launch's shape off the descriptor's hooks, and runs a findings engine
with stable rule IDs over the result:

    SMEM001   config shared memory a block over the card's budget  (error)
    BLK001    clamped config cannot tile the problem dims          (error)
    DTYPE001  float dtype outside the version's declared set       (error)
    DUP001    duplicate (CSE-able) expensive computations          (warning)
    CACHE001  stale tuned-config cache entry                       (error)
    MODEL001  declared model_step_s below the census bound         (error)
    KV001     shared-memory model ignores the gather buffers       (error)

Layers:
    census  — the plain version's op count: KernelCensus per (kernel,
              version, key), plus the launch's shape from the hooks
    rules   — Finding engine: audit_kernel / audit_registry / RULES

The census counts the plain version; the kernel's own instructions are
counted from its SASS (`core.sass`, `chip_smoke.py` phase 2b).

CLI: `python -m repro_torch.analyze [--strict] [--json out.json]
[--device cuda|cpu]`.

Example::

    from repro_torch import analyze
    report = analyze.audit_registry(["ssm"], skip_cache=True, device="cpu")
    [f.rule for f in report.errors]     # []
"""

from __future__ import annotations

_EXPORTS = {
    "KernelCensus": "repro_torch.analyze.census",
    "census_kernel": "repro_torch.analyze.census",
    "Finding": "repro_torch.analyze.rules",
    "RULES": "repro_torch.analyze.rules",
    "AuditReport": "repro_torch.analyze.rules",
    "audit_kernel": "repro_torch.analyze.rules",
    "audit_registry": "repro_torch.analyze.rules",
    "audit_tune_cache": "repro_torch.analyze.rules",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.analyze' has no "
                             f"attribute {name!r}") from None
    import importlib
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
