"""The port's static kernel auditor (`repro_torch.analyze`), its census
and rules, and the tune cache's validate/prune, held to the JAX package's
auditor (`repro.analyze`) on the CPU.

  * rule-engine parity — seven behaviours, each built as the reference's
    fake JAX kernel (tests/test_analyze.py's) and as the port's fake torch
    kernel, both through their own `audit_kernel`: the same rules fire at
    the same severities (VMEM001 <-> SMEM001);
  * census parity at the reference's canonical keys (bytes, flash's dot
    FLOPs, the scan's tensor-core FLOPs, gpp against the paper's count)
    and the port's own gpp goldens, pinned exactly;
  * the registry audit: clean on hw.DEFAULT_SPEC, the reference's rows;
  * the cache tools on tests/test_analyze.py's synthetic caches, written
    in each package's format;
  * the CLI with tests/_torch_badkernel.py.

The real-registry audits (~60 s for the port, ~15 s for the reference)
run once each, in module-scoped fixtures.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analyze import audit_registry as ref_audit_registry
from repro.analyze import rules as ref_rules
from repro.kernels import api as ref_api
from repro.tune import cache_tools as ref_cache_tools
from repro.tune import tuner as ref_tuner
from repro.tune.__main__ import main as ref_tune_main
from repro_torch.analyze import audit_registry, rules
from repro_torch.analyze.__main__ import main as analyze_main
from repro_torch.kernels import api
from repro_torch.kernels.gpp import problem
from repro_torch.tune import cache_tools, space, tuner
from repro_torch.tune.__main__ import main as tune_main

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
# the JAX version names the port renames
VERSION = {("flash", "pallas"): "cuda", ("ssm", "pallas"): "cuda"}
RULE = {"VMEM001": "SMEM001"}


@pytest.fixture(scope="module")
def port_report():
    return audit_registry(skip_cache=True, device="cpu")


@pytest.fixture(scope="module")
def ref_report():
    return ref_audit_registry(skip_cache=True)


def _by_row(censuses, rename=None):
    rename = rename or {}
    return {(c.kernel, rename.get((c.kernel, c.version), c.version),
             c.key_dims): c for c in censuses}


# ---------------------------------------------------------------------------
# (a) rule-engine parity: the reference's fake kernels and the port's
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Key:
    n: int = 64
    name: str = "fake"

    def key_dims(self) -> str:
        return str(self.n)


@dataclasses.dataclass(frozen=True)
class _Cfg:
    name: str = "cfg"
    blk: int = 8


class _RefFake(ref_api.Kernel):
    name = "fake"
    versions = ("v",)
    default_version = "v"

    def static_config(self, key, version):
        return _Cfg()

    def make_example(self, key, seed=0):
        return (jnp.asarray(np.ones((key.n, key.n), np.float32)),), {}

    def config_from_json(self, d):
        return _Cfg(**d)

    def run(self, x, *, version, config, interpret):
        return jnp.tanh(x) + x


class _PortFake(api.Kernel):
    name = "fake"
    versions = ("v",)
    default_version = "v"

    def static_config(self, key, version):
        return _Cfg()

    def make_example(self, key, seed=0, device="cpu"):
        return (torch.ones((key.n, key.n), device=device),), {}

    def config_from_json(self, d):
        return _Cfg(**d)

    def run(self, x, *, version, config, device):
        return torch.tanh(x) + x


def _oversized(base, port):
    class K(base):
        if port:
            def config_smem_bytes(self, config, key, *, version=None,
                                  spec=None):
                return 1 << 30                   # 1 GiB >> a block's
        else:
            def config_vmem_bytes(self, config, key):
                return 1 << 30
    return K()


def _cannot_tile(base, port):
    class K(base):
        def config_divides(self, config, key):
            return [f"n={key.n} not tiled by block 7"]
    return K()


def _dtype_leak(base, port):
    class K(base):
        def allowed_float_dtypes(self, version):
            return frozenset({"bfloat16"})      # but run computes in f32
    return K()


def _duplicate_muls(base, port):
    class K(base):
        if port:
            def run(self, x, *, version, config, device):
                return x * x + x * x            # identical expensive muls
        else:
            def run(self, x, *, version, config, interpret):
                return x * x + x * x
    return K()


def _model_too_fast(base, port):
    class K(base):
        def model_step_s(self, key, config, version, device=None):
            return 1e-15                        # faster than the hardware
    return K()


def _sane_model(base, port):
    class K(base):
        def model_step_s(self, key, config, version, device=None):
            return 1.0                          # far above any bound: fine
    return K()


def _gather_uncovered(base, port):
    class K(base):
        if port:
            def gather_buffer_bytes(self, config, key, *, version=None,
                                    spec=None):
                return 1 << 20                  # no shared-memory model
        else:
            def gather_buffer_bytes(self, config, key):
                return 1 << 20
    return K()


BEHAVIOURS = {
    "oversized-working-set": (_oversized, {"SMEM001": "error"}),
    "cannot-tile": (_cannot_tile, {"BLK001": "error"}),
    "dtype-leak": (_dtype_leak, {"DTYPE001": "error"}),
    "duplicate-muls": (_duplicate_muls, {"DUP001": "warning"}),
    "model-faster-than-hardware": (_model_too_fast, {"MODEL001": "error"}),
    "sane-model": (_sane_model, {}),
    "gather-uncovered": (_gather_uncovered, {"KV001": "error"}),
}


@pytest.mark.parametrize("behaviour", sorted(BEHAVIOURS))
def test_rule_engine_parity(behaviour):
    make, want = BEHAVIOURS[behaviour]
    _, ref_findings = ref_rules.audit_kernel(make(_RefFake, False), "v",
                                             _Key())
    _, findings = rules.audit_kernel(make(_PortFake, True), "v", _Key(),
                                     device="cpu")
    ref_fired = {RULE.get(f.rule, f.rule): f.severity for f in ref_findings}
    fired = {f.rule: f.severity for f in findings}
    assert fired == ref_fired == want
    for f in findings:
        assert f.kernel == "fake" and f.key_dims == "64" and f.message


# ---------------------------------------------------------------------------
# (b) census parity at the reference's canonical keys; the port's goldens
# ---------------------------------------------------------------------------

# (kernel, version, key_dims) whose compulsory bytes differ from the
# reference census's, with the reason: none do. Both count the same
# arrays in and out (gpp's float64 numpy inputs as f32 on both sides:
# JAX without x64, the port's problem.to_tensors).
BYTES_DIFFER = {}

# (total_flops, fma_pairable_flops) per gpp version at TINY: the plain
# versions' arithmetic, counted exactly (a changed number means a plain
# version's arithmetic changed). v6-v10 count the kernels' block
# decomposition in torch (gpp_cuda._plain_partials, one term_planes a
# band and frequency), not the compiled band loop (the SASS census).
GOLDEN_GPP_TINY = {
    "v0": (737540.0, 462976.0),
    "v1": (786692.0, 462976.0),
    "v2": (770308.0, 462976.0),
    "v3": (753924.0, 462976.0),
    "v4": (858324.0, 479360.0),
    "v5": (825492.0, 462976.0),
    "v6": (713012.0, 429632.0),
    "v7": (713012.0, 429632.0),
    "v8": (713012.0, 429632.0),
    "v9": (713012.0, 429632.0),
    "v10": (713012.0, 429632.0),
}


def test_census_bytes_match_reference(port_report, ref_report):
    port = _by_row(port_report.censuses)
    ref = _by_row(ref_report.censuses, VERSION)
    assert set(port) == set(ref)
    differ = {row: (c.hbm_bytes, ref[row].hbm_bytes)
              for row, c in port.items() if c.hbm_bytes != ref[row].hbm_bytes}
    assert set(differ) == set(BYTES_DIFFER), differ


def test_census_flash_and_scan_flops(port_report, ref_report):
    port = _by_row(port_report.censuses)
    ref = _by_row(ref_report.censuses, VERSION)
    fk = api.get_kernel("flash").canonical_keys()[0].key_dims()
    assert port[("flash", "cuda", fk)].dot_flops == 8388608.0
    assert ref[("flash", "cuda", fk)].dot_flops == 8388608.0
    # the plain version takes f32 products (it upcasts bf16 q/k/v), so
    # none of its FLOPs are at the tensor cores' rate
    assert port[("flash", "cuda", fk)].tc_flops == 0.0
    assert "bfloat16" in port[("flash", "cuda", fk)].float_dtypes
    sk = api.get_kernel("ssm").canonical_keys()[0].key_dims()
    # the scan form: 0 FLOPs at the tensor-core rate on both sides. The
    # reference's Pallas scan has no dot at all; the port's plain scan
    # contracts h c over N with an f32 bmm (2 B T C N = 65,536 FLOPs)
    assert ref[("ssm", "cuda", sk)].dot_flops == 0.0
    for version in ("ref", "cuda"):
        assert port[("ssm", version, sk)].tc_flops == 0.0
    assert port[("ssm", "cuda", sk)].dot_flops == 65536.0
    assert port[("ssm", "chunked", sk)].dot_flops > 0
    assert ref[("ssm", "chunked", sk)].dot_flops > 0


def test_census_gpp_goldens(port_report):
    port = _by_row(port_report.censuses)
    k = api.get_kernel("gpp")
    assert set(GOLDEN_GPP_TINY) == set(k.versions)
    for version, (flops, fma_flops) in GOLDEN_GPP_TINY.items():
        c = port[("gpp", version, problem.TINY.key_dims())]
        assert (c.flops, c.fma_flops) == (flops, fma_flops), version
        assert 0.0 < c.fma_fraction < 1.0
        assert c.float_dtypes == ("complex64", "float32")
    for size in (problem.TINY, problem.BENCH):
        for version in k.versions:
            c = port[("gpp", version, size.key_dims())]
            # within 2x of the paper-derived analytic count
            assert 0.5 < c.flops / size.total_flops() < 2.0, (version, size)


def test_census_launch_columns(port_report):
    """Plain-only versions have no launch; the kernels' launches carry the
    hooks' shared memory and grid, priced on the spec given."""
    plain_only = {("flash", "ref"), ("ssm", "ref"), ("ssm", "chunked"),
                  ("paged_decode", "ref")} | {
                      ("gpp", f"v{i}") for i in range(6)}
    for c in port_report.censuses:
        if (c.kernel, c.version) in plain_only:
            assert c.smem_config_bytes is None and c.grid_blocks is None
            assert c.model_s is None
        else:
            assert 0 < c.smem_config_bytes <= 232_448, c
            assert c.grid_blocks >= 1 and c.model_s > 0
        assert c.smem_launch_bytes is None        # the library: card only
        assert c.bound_s > 0 and c.unbounded_loops == 0
    assert port_report.spec == "h100-sxm5"


# ---------------------------------------------------------------------------
# (c) the registry audit
# ---------------------------------------------------------------------------

def test_registry_audit_clean_and_rows_match_reference(port_report,
                                                       ref_report):
    assert port_report.errors == [], [f.row() for f in port_report.errors]
    assert ref_report.errors == []
    assert len(port_report.censuses) == sum(
        len(api.get_kernel(n).canonical_keys()) * len(api.get_kernel(n).versions)
        for n in api.list_kernels())
    payload = port_report.to_json()
    assert payload["schema"] == "repro_torch-analyze/v1"
    assert payload["n_errors"] == 0
    assert set(payload["rules"]) == set(rules.RULES) == {
        RULE.get(r, r) for r in ref_rules.RULES}
    assert {r: rules.RULES[r][0] for r in rules.RULES} == {
        RULE.get(r, r): sev for r, (sev, _) in ref_rules.RULES.items()}
    assert rules.DUP_FRACTION == ref_rules.DUP_FRACTION
    assert rules.DRIFT_TOL == ref_rules.DRIFT_TOL
    rows = [(c.kernel, c.version, c.key_dims) for c in port_report.censuses]
    ref_rows = [(c.kernel, VERSION.get((c.kernel, c.version), c.version),
                 c.key_dims) for c in ref_report.censuses]
    assert rows == ref_rows
    json.dumps(payload)                  # the report serializes


# ---------------------------------------------------------------------------
# (d) cache tools on tests/test_analyze.py's synthetic caches
# ---------------------------------------------------------------------------

# tests/test_analyze.py's caches sit at gpp dims 64x8x8x2, where the
# port's Hopper space is empty (blk_igp starts at 32), so an entry there
# gets existence-only validation; the port's caches take the same roles
# at BENCH's dims, where its space is not empty.
PORT_DIMS = problem.BENCH.key_dims()


def _ref_entry(version="v10", blk_ig=64):
    return {"kernel": "gpp",
            "config": {"name": version, "blk_ig": blk_ig, "blk_igp": 8,
                       "blk_band": 8, "aqsm_transposed": True,
                       "fused_acc": True}}


def _port_entry(version="v10", blk_ig=None):
    cfg = space.candidates(problem.BENCH)[0]
    if blk_ig is not None:
        cfg = dataclasses.replace(cfg, blk_ig=blk_ig)
    return {"kernel": "gpp", "config": dataclasses.asdict(
        dataclasses.replace(cfg, name=version))}


def _caches(roles):
    """{role: (ref key, ref entry)} and {role: (port key, port entry)}."""
    ref, port = {}, {}
    for role in roles:
        if role == "valid":
            ref[role] = ("gpp|64x8x8x2|cpu|v10", _ref_entry())
            port[role] = (f"gpp|{PORT_DIMS}|cpu|v10", _port_entry())
        elif role == "gone-version":
            ref[role] = ("gpp|64x8x8x2|cpu|v99", _ref_entry("v99"))
            port[role] = (f"gpp|{PORT_DIMS}|cpu|v99", _port_entry("v99"))
        elif role == "gone-kernel":
            ref[role] = ("gone|64x8x8x2|cpu|v1", _ref_entry())
            port[role] = (f"gone|{PORT_DIMS}|cpu|v1", _port_entry())
        elif role == "malformed":
            ref[role] = ("gpp|64x8x8x2|cpu", _ref_entry())
            port[role] = (f"gpp|{PORT_DIMS}|cpu", _port_entry())
        elif role == "bad-config":
            bad = {"kernel": "gpp", "config": {"name": "x", "nope": 1}}
            ref[role] = ("gpp|64x8x8x2|tpu|v10", bad)
            port[role] = (f"gpp|{PORT_DIMS}|cuda|v10", bad)
        elif role == "outside-space":
            # blk_ig 3 divides nothing in either menu
            ref[role] = ("gpp|64x8x8x2|cpu|v10", _ref_entry(blk_ig=3))
            port[role] = (f"gpp|{PORT_DIMS}|cpu|v10", _port_entry(blk_ig=3))
    return ref, port


def _write(path, file_name, entries):
    path.mkdir(parents=True, exist_ok=True)
    (path / file_name).write_text(json.dumps(
        {key: entry for key, entry in entries.values()}))
    return str(path)


def _both(tmp_path, roles):
    ref, port = _caches(roles)
    return (_write(tmp_path / "ref", ref_tuner.CACHE_FILE, ref), ref,
            _write(tmp_path / "port", tuner.CACHE_FILE, port), port)


def _reasons(issues, keys):
    role_of = {key: role for role, (key, _) in keys.items()}
    return {role_of[i.key]: i.reason for i in issues}


def test_validate_cache_reasons_match_reference(tmp_path):
    roles = ("valid", "gone-version", "gone-kernel", "malformed",
             "bad-config")
    ref_dir, ref, port_dir, port = _both(tmp_path, roles)
    want = _reasons(ref_cache_tools.validate_cache(ref_dir), ref)
    assert want == {"gone-version": "unknown-version",
                    "gone-kernel": "unknown-kernel",
                    "malformed": "malformed-key",
                    "bad-config": "bad-config"}
    assert _reasons(cache_tools.validate_cache(port_dir), port) == want


def test_validate_cache_outside_space_matches_reference(tmp_path):
    ref_dir, ref, port_dir, port = _both(tmp_path, ("outside-space",))
    ref_issues = ref_cache_tools.validate_cache(ref_dir)
    issues = cache_tools.validate_cache(port_dir)
    assert [i.reason for i in issues] == [i.reason for i in ref_issues] \
        == ["outside-space"]
    assert (issues[0].kernel, issues[0].version) == ("gpp", "v10")


def test_validate_cache_clean_and_missing(tmp_path):
    assert cache_tools.validate_cache(str(tmp_path / "nope")) == [] \
        == ref_cache_tools.validate_cache(str(tmp_path / "nope"))
    ref_dir, _, port_dir, _ = _both(tmp_path, ("valid",))
    assert cache_tools.validate_cache(port_dir) == [] \
        == ref_cache_tools.validate_cache(ref_dir)


def test_prune_cache_matches_reference(tmp_path):
    ref_dir, ref, port_dir, port = _both(tmp_path,
                                         ("valid", "gone-version"))
    results = []
    for tools, d, keys in ((ref_cache_tools, ref_dir, ref),
                           (cache_tools, port_dir, port)):
        with pytest.warns(UserWarning, match="v99"):
            kept, dropped = tools.prune_cache(d)
        left = json.loads(open(os.path.join(
            d, os.listdir(d)[0])).read())
        assert list(left) == [keys["valid"][0]]
        assert tools.validate_cache(d) == []
        results.append((kept, _reasons(dropped, keys)))
    assert results[0] == results[1] == (1, {"gone-version":
                                            "unknown-version"})


def test_prune_dry_run_matches_reference(tmp_path):
    ref_dir, _, port_dir, _ = _both(tmp_path, ("gone-version",))
    for tools, d, name in ((ref_cache_tools, ref_dir, ref_tuner.CACHE_FILE),
                           (cache_tools, port_dir, tuner.CACHE_FILE)):
        before = open(os.path.join(d, name)).read()
        with pytest.warns(UserWarning):
            kept, dropped = tools.prune_cache(d, dry_run=True)
        assert kept == 0 and len(dropped) == 1
        assert open(os.path.join(d, name)).read() == before


def test_tune_cli_exit_codes_match_reference(tmp_path):
    ref_dir, _, port_dir, _ = _both(tmp_path, ("valid", "gone-version"))
    codes = []
    for main, d in ((ref_tune_main, ref_dir), (tune_main, port_dir)):
        stale = main(["validate", "--cache-dir", d])
        with pytest.warns(UserWarning):
            pruned = main(["prune", "--cache-dir", d])
        codes.append([stale, pruned, main(["validate", "--cache-dir", d])])
    assert codes[0] == codes[1] == [1, 0, 0]


def test_audit_registry_reports_cache_findings(tmp_path):
    ref_dir, _, port_dir, _ = _both(tmp_path, ("gone-version",))
    found = []
    for audit, d, kw in ((ref_audit_registry, ref_dir, {}),
                         (audit_registry, port_dir, {"device": "cpu"})):
        before = open(os.path.join(d, os.listdir(d)[0])).read()
        report = audit(["ssm"], cache_dir=d, **kw)
        cache = [f for f in report.findings if f.rule == "CACHE001"]
        assert len(cache) == 1 and cache[0].severity == "error"
        found.append(dict(cache[0].data)["reason"])
        # the validator is read-only: the stale entry is still there
        assert open(os.path.join(d, os.listdir(d)[0])).read() == before
    assert found == ["unknown-version"] * 2


# ---------------------------------------------------------------------------
# (e) the CLI
# ---------------------------------------------------------------------------

def test_cli_strict_with_the_broken_fixture(tmp_path):
    sys.path.insert(0, TESTS_DIR)
    try:
        out = tmp_path / "report.json"
        args = ["--device", "cpu", "--no-cache", "--kernel", "badfix",
                "--extra-module", "_torch_badkernel"]
        assert analyze_main(args + ["--strict", "--json", str(out)]) == 1
        payload = json.loads(out.read_text())
        assert payload["schema"] == "repro_torch-analyze/v1"
        assert "SMEM001" in {f["rule"] for f in payload["findings"]}
        assert payload["n_errors"] >= 1
        # report-only without --strict
        assert analyze_main(args) == 0
        if not torch.cuda.is_available():
            # the default device is the card: no silent CPU audit
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                analyze_main(args[2:])
    finally:
        sys.path.remove(TESTS_DIR)
        api._REGISTRY.pop("badfix", None)
