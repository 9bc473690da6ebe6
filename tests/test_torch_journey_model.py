"""The journey's modeled Hopper roofline (`repro_torch.core.journey`), the
v8 block sweep, the tuner's GPP shorthands, `measure.time_config` and the
science example, on the CPU: model only, or measured at TINY.

The plain versions v0–v5 are modeled from their census, which the
journey takes at BENCH (~30 s of fake-tensor ops on this CPU); these
tests take it at TINY (`journey.CENSUS_SIZE`), which exercises the same
per-term scaling in a second.
"""

import dataclasses
import re

import pytest

from repro.kernels.gpp import problem as jproblem
from repro.tune import tuner as jtuner
import repro.tune as jtune
from repro_torch.core import gpu_model, hw, journey, roofline
from repro_torch.kernels.gpp import gpp_cuda, problem
from repro_torch.tune import measure, space, tuner
import repro_torch.tune as ttune


@pytest.fixture(autouse=True)
def tiny_census(monkeypatch):
    monkeypatch.setattr(journey, "CENSUS_SIZE", problem.TINY)


def test_modeled_journey_si214():
    rows = journey.run_journey("si214", measure=False, verbose=False)
    assert [r.version for r in rows] == list(journey.VERSIONS)
    spec = hw.DEFAULT_SPEC
    size = problem.SI214
    for r in rows:
        rep = r.report
        assert isinstance(rep, roofline.RooflineReport)
        assert r.ms is None and r.rel_err is None and r.device == "model"
        assert rep.extra["source"]
        assert rep.flops_per_chip == size.total_flops()
        assert rep.memory_s == rep.bytes_per_chip / spec.hbm_bw
        assert rep.extra["ai_hbm"] == size.total_flops() / rep.bytes_per_chip
        assert r.modeled_ms == rep.modeled_step_s * 1e3 > 0
        assert r.modeled_tflops == pytest.approx(
            size.total_flops() / rep.modeled_step_s / 1e12)
        assert spec.fp32_flops / 2 <= rep.customized_peak_flops \
            <= spec.fp32_flops
    by = {r.version: r for r in rows}
    for v in ("v0", "v1", "v2", "v3", "v4", "v5"):
        rep = by[v].report
        assert "census" in rep.extra["source"]
        assert rep.dominant == "memory"          # eager: bytes of every op
        assert rep.extra["ai_smem"] is None and rep.extra["launches"] > 0
        assert rep.customized_peak_flops == roofline.fma_ceiling(
            rep.extra["fma_fraction"], spec)
    for v in ("v6", "v7", "v8", "v9", "v10"):
        rep = by[v].report
        assert "SASS" in rep.extra["source"]
        assert rep.dominant == "compute"         # instruction issue
        cfg = gpp_cuda.BlockConfig(**by[v].config)
        loop = gpu_model.band_loop(cfg)
        assert rep.compute_s == gpu_model.issue_s(size, cfg, loop.instr,
                                                  spec)
        assert rep.extra["instr_per_term"] == loop.instr
        assert rep.bytes_per_chip == gpp_cuda.hbm_traffic_model(size, cfg)
        assert rep.extra["ai_smem"] == 90.0 / gpu_model.band_loop(
            cfg).lds_bytes
    # v6-v8 are charged their own kernel's count, v9/v10 gpp_fused's
    assert by["v6"].report.extra["instr_per_term"] == \
        gpu_model.BAND_LOOP[(False, False, 4)].instr
    assert by["v8"].report.extra["instr_per_term"] == \
        gpu_model.BAND_LOOP[(False, True, 1)].instr
    assert by["v9"].report.extra["instr_per_term"] == gpu_model.INSTR_PER_TERM
    # a gpp_fused config at EPT > 1 is charged its own loop's count, not
    # the ranking's INSTR_PER_TERM
    cfg = next(c for c in space.candidates(size) if c.ept_instance() > 1)
    rep = journey._model_report("v10", size, spec, cfg)
    assert rep.extra["instr_per_term"] == gpu_model.BAND_LOOP[
        (True, True, cfg.ept_instance())].instr != gpu_model.INSTR_PER_TERM
    assert rep.compute_s != gpu_model.step_terms(size, cfg, spec)[0]
    # v10 runs under the tuner's model-ranked first
    first = tuner.rank(size, version="v10")[0][0]
    assert by["v10"].config == dataclasses.asdict(
        dataclasses.replace(first, name="v10"))
    table = journey.format_journey(rows, "si214")
    assert "modeled only" in table
    assert len(re.findall(r"^\| v\d", table, re.M)) == 11


def test_measured_journey_tiny_on_cpu():
    rows = journey.run_journey("tiny", device="cpu", warmup=0, reps=1,
                               versions=("v0", "v5", "v8", "v10"),
                               verbose=False)
    for r in rows:
        assert r.ms > 0 and r.rel_err < 1e-4 and r.device == "cpu"
        assert r.measured_over_modeled == r.ms / r.modeled_ms
        assert r.card is None and r.peak_share is None
        assert r.version in journey.format_row(r)
    table = journey.format_journey(rows, "tiny")
    assert "measured on cpu" in table


def test_sweep_blocks_sorted_and_feasible():
    spec = hw.DEFAULT_SPEC
    size = problem.SI214
    rows = journey.sweep_blocks("si214", spec)
    assert rows
    times = [r["modeled_s"] for r in rows]
    assert times == sorted(times)
    for r in rows:
        assert r["smem_bytes"] <= spec.smem_per_block
        assert r["waves"] >= 1
        assert (size.ncouls % r["blk_ig"], size.ngpown % r["blk_igp"],
                size.nbands % r["blk_band"]) == (0, 0, 0)
        cfg = gpp_cuda.BlockConfig("s", r["blk_ig"], r["blk_igp"],
                                   r["blk_band"], True, False, r["threads"])
        assert gpu_model.resident_blocks(cfg, spec) >= 1
        assert r["blocks"] == gpp_cuda.grid_blocks(size, cfg)
        assert r["modeled_s"] == gpu_model.step_s(size, cfg, spec)


def test_cache_key_matches_jax():
    for size in ("tiny", "bench", "si214", "si510"):
        for tag, version in (("cpu", "v10"), ("cuda:NVIDIA H100 80GB "
                                              "HBM3:sm90", "v8")):
            assert tuner.cache_key(problem.SIZES[size], tag, version) == \
                jtuner.cache_key(jproblem.SIZES[size], tag, version)


def test_gpp_shorthands(tmp_path):
    size = problem.BENCH
    assert tuner.DEFAULT_VERSION == jtuner.DEFAULT_VERSION == "v10"
    assert tuner.rank(size) == tuner.rank_kernel("gpp", size, version="v10")
    tuner.clear_memo()
    cache = str(tmp_path / "tune")
    tc = tuner.tune(size, device="cpu", cache_dir=cache)
    assert tc.source == "model"
    assert tc.key == tuner.cache_key(size, "cpu", "v10")
    assert tuner.best_config(size, device="cpu", cache_dir=cache) \
        == tc.config == dataclasses.replace(tuner.rank(size)[0][0],
                                            name="v10")
    # the names the reference's tune package exports
    assert sorted(ttune.__all__) == sorted(jtune.__all__)
    for name in ttune.__all__:
        assert getattr(ttune, name) is not None


def test_time_config_honors_zero_warmup(monkeypatch):
    """warmup=0 makes no warm-up call; a negative one is clamped to 0."""
    calls = []
    monkeypatch.setattr(gpp_cuda, "gpp_cuda",
                        lambda t, cfg: calls.append(cfg))
    inputs = problem.make_inputs(problem.TINY)
    cfg = gpp_cuda.V9.clamped(problem.TINY)
    for warmup, want in ((0, 2), (-3, 2), (1, 3)):
        calls.clear()
        s = measure.time_config(inputs, cfg, device="cpu", warmup=warmup,
                                reps=2)
        assert len(calls) == want and s >= 0
        assert all(c is cfg for c in calls)
    with pytest.raises(TypeError):          # no default device
        measure.time_config(inputs, cfg)


def test_science_example_model_only(capsys):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "gpp_science_torch.py")
    spec = importlib.util.spec_from_file_location("gpp_science_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--no-measure", "--sweep", "--tune"])
    out = capsys.readouterr().out
    assert "| ver | measured ms | modeled ms |" in out
    assert len(re.findall(r"^\| v\d", out, re.M)) == 11
    assert "modeled speedup v8/v0" in out and "2.36x" in out
    assert "v8 block sweep" in out and "tuner ranking" in out
    assert out.count("  blk=(") == 20
