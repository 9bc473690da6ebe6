"""Findings engine for the static kernel auditor — the port of
`repro.analyze.rules`. Each rule has a stable ID and severity; `--strict`
fails on any `error`-severity finding:

  SMEM001  error    the config's shared memory a block (dynamic + static)
                    exceeds `GpuSpec.smem_per_block` (232,448 B on an
                    H100): the launch would be refused (the JAX package's
                    VMEM001 against the TPU's VMEM)
  BLK001   error    the clamped config still cannot tile the problem dims
  DTYPE001 error    the plain version touches a float dtype outside the
                    version's declared set (a promotion leak)
  DUP001   warning  >= DUP_FRACTION of census FLOPs recompute identical
                    expensive ops (CSE/remat waste)
  CACHE001 error    a tune-cache entry is stale: kernel/version gone,
                    config unparseable, or outside the current space
  MODEL001 error    the declared model_step_s is below DRIFT_TOL x the
                    census roofline bound (the model promises to beat
                    the card's ceilings)
  KV001    error    the kernel declares gather buffers (paged decode's
                    cp.async K/V ring, `gather_buffer_bytes`) its
                    `config_smem_bytes` does not cover: the config would
                    pass SMEM001 and overflow at launch
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import backend
from repro_torch.analyze.census import (KernelCensus, census_kernel,
                                        resolve_config)
from repro_torch.core import hw

SEV_ERROR = "error"
SEV_WARNING = "warning"

RULES: Dict[str, Tuple[str, str]] = {
    "SMEM001": (SEV_ERROR, "config shared memory a block exceeds budget"),
    "BLK001": (SEV_ERROR, "block config cannot tile problem dims"),
    "DTYPE001": (SEV_ERROR, "float dtype outside declared compute path"),
    "DUP001": (SEV_WARNING, "duplicate expensive computation"),
    "CACHE001": (SEV_ERROR, "stale tuned-config cache entry"),
    "MODEL001": (SEV_ERROR, "model drift vs census roofline bound"),
    "KV001": (SEV_ERROR, "shared-memory model ignores gather buffers"),
}

# DUP001 fires when recomputed FLOPs exceed this fraction of the census
DUP_FRACTION = 0.10
# MODEL001 fires when model_step_s < DRIFT_TOL * bound_s. A model may sit
# far above the bound (launch latency, partial waves); only one that
# promises more than 2.5x the card's ceilings is drift.
DRIFT_TOL = 0.4
SCHEMA = "repro_torch-analyze/v1"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One audit finding, addressable by stable rule ID."""
    rule: str
    severity: str
    kernel: str
    version: str
    key_dims: str
    message: str
    data: Tuple[Tuple[str, Any], ...] = ()

    def row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["data"] = dict(self.data)
        return d


def _finding(rule: str, kernel: str, version: str, key_dims: str,
             message: str, **data) -> Finding:
    sev, _ = RULES[rule]
    return Finding(rule=rule, severity=sev, kernel=kernel, version=version,
                   key_dims=key_dims, message=message,
                   data=tuple(sorted(data.items())))


def audit_kernel(kernel, version: str, key, *,
                 spec: Optional[hw.GpuSpec] = None,
                 device=backend.DEFAULT_DEVICE
                 ) -> Tuple[KernelCensus, List[Finding]]:
    """Census one `(kernel, version, key)` (`census.census_kernel`) and
    run every per-kernel rule against it on `spec` (default: the spec of
    `device`, the card unless device='cpu'). Returns the census and its
    findings (possibly none)."""
    from repro_torch.kernels import api
    k = api.get_kernel(kernel) if isinstance(kernel, str) else kernel
    device = backend.resolve_device(device)
    spec = spec or hw.spec_for_device(device)
    census = census_kernel(k, version, key, spec=spec, device=device)
    kd = census.key_dims
    findings: List[Finding] = []

    cfg = resolve_config(k, version, key, spec)
    if cfg is not None:
        clamped = k.clamp(cfg, key)
        smem = census.smem_config_bytes
        if smem is not None and smem > spec.smem_per_block:
            findings.append(_finding(
                "SMEM001", k.name, version, kd,
                f"config needs {smem} B of shared memory a block > budget "
                f"{spec.smem_per_block} B", smem_bytes=smem,
                budget_bytes=spec.smem_per_block))
        for violation in k.config_divides(clamped, key):
            findings.append(_finding(
                "BLK001", k.name, version, kd,
                f"clamped config cannot tile problem: {violation}"))
        gather = k.gather_buffer_bytes(clamped, key, version=version,
                                       spec=spec)
        if gather is not None and (smem is None or smem < gather):
            findings.append(_finding(
                "KV001", k.name, version, kd,
                f"declared gather buffers need {gather} B but the config's "
                f"shared-memory model covers "
                f"{'nothing' if smem is None else f'only {smem} B'}",
                gather_bytes=gather, smem_bytes=smem))

    allowed = k.allowed_float_dtypes(version)
    if allowed:
        leaked = sorted(set(census.float_dtypes) - set(allowed))
        if leaked:
            findings.append(_finding(
                "DTYPE001", k.name, version, kd,
                f"plain version touches {leaked} outside declared "
                f"{sorted(allowed)}", leaked=leaked))

    if (census.flops > 0 and census.duplicate_eqns > 0
            and census.duplicate_flops / census.flops > DUP_FRACTION):
        frac = census.duplicate_flops / census.flops
        findings.append(_finding(
            "DUP001", k.name, version, kd,
            f"{census.duplicate_eqns} duplicate ops recompute "
            f"{100 * frac:.0f}% of census FLOPs",
            duplicate_eqns=census.duplicate_eqns,
            duplicate_flops=census.duplicate_flops))

    if census.model_s is not None and census.bound_s > 0 \
            and census.model_s < DRIFT_TOL * census.bound_s:
        findings.append(_finding(
            "MODEL001", k.name, version, kd,
            f"model_step_s {census.model_s:.3g}s < {DRIFT_TOL} x census "
            f"roofline bound {census.bound_s:.3g}s",
            model_s=census.model_s, bound_s=census.bound_s,
            ratio=census.model_s / census.bound_s))

    return census, findings


def audit_tune_cache(cache_dir: Optional[str] = None) -> List[Finding]:
    """CACHE001 over the tuned-config cache, through the read-only half of
    the cache tooling (`tune.cache_tools.validate_cache`)."""
    from repro_torch.tune import cache_tools
    return [_finding("CACHE001", issue.kernel or "?", issue.version or "?",
                     issue.dims or "?",
                     f"stale cache entry {issue.key!r}: {issue.detail}",
                     cache_key=issue.key, reason=issue.reason)
            for issue in cache_tools.validate_cache(cache_dir)]


@dataclasses.dataclass
class AuditReport:
    """The full registry audit: every census row and every finding."""
    censuses: List[KernelCensus]
    findings: List[Finding]
    spec: str = hw.DEFAULT_SPEC.name

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == SEV_WARNING]

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "spec": self.spec,
            "rules": {rid: {"severity": sev, "title": title}
                      for rid, (sev, title) in RULES.items()},
            "censuses": [c.row() for c in self.censuses],
            "findings": [f.row() for f in self.findings],
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
        }


def audit_registry(kernels: Optional[List[str]] = None, *,
                   cache_dir: Optional[str] = None,
                   spec: Optional[hw.GpuSpec] = None,
                   skip_cache: bool = False,
                   device=backend.DEFAULT_DEVICE) -> AuditReport:
    """Audit every registered kernel family at its canonical shapes, every
    version, plus the tune cache — the engine behind `python -m
    repro_torch.analyze`. `spec` defaults to the spec of `device`: the
    card's (raises without one), where each census also reads the
    library's own shared memory of its launch, or hw.DEFAULT_SPEC for
    device='cpu'.

    Example::

        from repro_torch.analyze import audit_registry
        report = audit_registry(["ssm"], skip_cache=True, device="cpu")
        assert not report.errors
    """
    from repro_torch.kernels import api
    device = backend.resolve_device(device)
    spec = spec or hw.spec_for_device(device)
    names = kernels if kernels is not None else api.list_kernels()
    censuses: List[KernelCensus] = []
    findings: List[Finding] = []
    for name in names:
        k = api.get_kernel(name)
        for key in k.canonical_keys():
            for version in k.versions:
                census, fs = audit_kernel(k, version, key, spec=spec,
                                          device=device)
                censuses.append(census)
                findings.extend(fs)
    if not skip_cache:
        findings.extend(audit_tune_cache(cache_dir))
    return AuditReport(censuses=censuses, findings=findings, spec=spec.name)
