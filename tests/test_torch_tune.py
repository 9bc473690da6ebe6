"""repro_torch.tune, core.hw, core.gpu_model and core.journey: the Hopper
config space meets shared-memory and register limits, the model ranks
deterministically, the tune cache round-trips in its own file keyed by
the device tag (a CPU pick is never served on the card, and neither
package reads the other's entries), and the journey runs at TINY on the
CPU."""

import json
import math
import os

import pytest
import torch
from _prop import given, settings, st

from repro.tune import tuner as jax_tuner
from repro_torch import backend
from repro_torch.core import gpu_model, hw
from repro_torch.core.journey import VERSIONS, format_row, run_journey
from repro_torch.kernels import api
from repro_torch.kernels.gpp import gpp_cuda, problem
from repro_torch.tune import measure, space, tuner

SMALL = problem.GppSize("small", nbands=8, ngpown=32, ncouls=64)


def _check_candidate(size, cfg):
    assert size.ncouls % cfg.blk_ig == 0, cfg
    assert size.ngpown % cfg.blk_igp == 0, cfg
    assert size.nbands % cfg.blk_band == 0, cfg
    assert cfg.smem_bytes(size.nw) <= gpp_cuda.SMEM_PER_BLOCK, cfg
    assert cfg.regs_estimate() <= gpp_cuda.REGS_PER_THREAD, cfg
    assert cfg.regs_estimate() * cfg.threads <= gpp_cuda.REGS_PER_SM, cfg
    assert cfg.ept_instance() in gpp_cuda.EPT_INSTANCES, cfg
    assert cfg.threads % 32 == 0 and cfg.blk_ig * cfg.blk_igp >= cfg.threads
    assert gpu_model.resident_blocks(cfg, nw=size.nw) >= 1, cfg


@pytest.mark.parametrize("size_name", ["bench", "si214", "si510"])
def test_candidates_fit_hopper(size_name):
    size = problem.SIZES[size_name]
    cands = space.candidates(size)
    assert cands, size_name
    for cfg in cands:
        _check_candidate(size, cfg)
        assert cfg.fused_acc and cfg.aqsm_transposed
    assert all(not c.fused_acc for c in space.candidates(size, fused=False))


def test_tiny_has_no_candidates():
    # ngpown=8 < 32: dispatch falls back to the clamped static config
    assert space.candidates(problem.TINY) == []


@settings(max_examples=12, deadline=None)
@given(nbands=st.sampled_from([8, 32, 96, 1024, 2560]),
       ngpown=st.sampled_from([8, 64, 128, 1024]),
       ncouls=st.sampled_from([64, 512, 8192, 20480]))
def test_candidates_fit_hopper_property(nbands, ngpown, ncouls):
    size = problem.GppSize("prop", nbands=nbands, ngpown=ngpown, ncouls=ncouls)
    for cfg in space.candidates(size):
        _check_candidate(size, cfg)


def test_rank_sorted_and_deterministic():
    ranked = tuner.rank_kernel("gpp", problem.SI214)
    times = [t for _, t in ranked]
    assert times == sorted(times)
    assert all(math.isfinite(t) and t > 0 for t in times)
    assert ranked == tuner.rank_kernel("gpp", problem.SI214)


def test_model_terms():
    s = problem.SI214
    for cfg in list(gpp_cuda.CONFIGS.values()) + space.candidates(s)[:20]:
        assert gpu_model.wave_quantisation(s, cfg) >= 1.0
        compute, memory = gpu_model.step_terms(s, cfg)
        assert compute > memory          # compute-bound at Si-214
    # the issue roof: the SASS census's instructions a term (89.5) over SMs
    # x 128 lanes x clock
    issue = s.inner_iters * gpu_model.INSTR_PER_TERM / \
        hw.H100_SXM5.fp32_lane_ops_per_s
    assert 0.040 < issue < 0.050
    assert issue <= gpu_model.step_terms(s, gpp_cuda.V9)[0] < 1.02 * issue
    # v7 -> v8 raises the warps a SM holds (registers: 4 elements a thread
    # -> 1); the resident-block count the wave term uses sees it
    warps = {c.name: gpu_model.resident_blocks(c) * c.threads // 32
             for c in (gpp_cuda.V7, gpp_cuda.V8)}
    assert warps == {"v7": 16, "v8": 32}


def test_specs_name_their_part():
    assert hw.spec_for_name("NVIDIA H100 80GB HBM3") is hw.H100_SXM5
    assert hw.spec_for_name("NVIDIA H100 PCIe") is hw.H100_PCIE
    with pytest.raises(ValueError):
        hw.spec_for_name("NVIDIA A100-SXM4-80GB")
    assert hw.spec_for_device("cpu") is hw.DEFAULT_SPEC
    for spec in hw.SPECS.values():
        assert spec.smem_per_block == 232_448
        assert spec.regs_per_sm == 65_536 and spec.regs_per_thread == 255
        # published FP32 rate = lanes x 2 (FMA) x boost clock, within 2%
        assert spec.fp32_flops == pytest.approx(
            2 * spec.fp32_lane_ops_per_s, rel=0.02)
    assert (hw.H100_SXM5.fp32_flops, hw.H100_SXM5.hbm_bw) == (67e12, 3.35e12)
    assert (hw.H100_PCIE.fp32_flops, hw.H100_PCIE.hbm_bw) == (51e12, 2.0e12)


# ---------------------------------------------------------------------------
# tune + cache
# ---------------------------------------------------------------------------

def test_tune_cache_round_trip(tmp_path, monkeypatch):
    cache = str(tmp_path / "tune")
    tuner.clear_memo()
    tc = tuner.tune_kernel("gpp", problem.BENCH, device="cpu", cache_dir=cache)
    assert tc.source == "model" and tc.config.name == "v10"
    assert tc.key == "gpp|512x64x64x2|cpu|v10"
    path = os.path.join(cache, "kernel_tune_torch.json")
    assert json.load(open(path)).keys() == {tc.key}

    tuner.clear_memo()
    monkeypatch.setattr(tuner, "rank_kernel",
                        lambda *a, **k: pytest.fail("cache missed"))
    tc2 = tuner.tune_kernel("gpp", problem.BENCH, device="cpu", cache_dir=cache)
    assert tc2.source == "cache"
    assert tc2.config == tc.config and tc2.modeled_s == tc.modeled_s


def test_tune_measured_pass_and_memo(tmp_path):
    tuner.clear_memo()
    cache = str(tmp_path / "tune")
    tc = tuner.tune_kernel("gpp", SMALL, device="cpu", cache_dir=cache,
                           measure_mode=True, top_k=2, reps=1, warmup=1)
    assert tc.source == "measured"
    assert tc.measured_s is not None and tc.measured_s > 0
    assert tuner.tune_kernel("gpp", SMALL, device="cpu", cache_dir=cache) is tc


def test_tune_always_times_the_static_config(tmp_path, monkeypatch):
    # v9's clamped blocks are timed even where the model ranks them below
    # top_k, so a tuned v10 is never slower than the static v9
    k = api.get_kernel("gpp")
    static = k.finalize_config(k.static_config(SMALL, "v10"), "v10")
    ranked = tuner.rank_kernel("gpp", SMALL)[::-1]     # a model that errs
    assert k.finalize_config(ranked[0][0], "v10") != static
    monkeypatch.setattr(tuner, "rank_kernel", lambda *a, **kw: ranked)
    times = iter([2.0, 1.0])                 # the static config is timed last
    monkeypatch.setattr(tuner.measure, "time_callable",
                        lambda fn, **kw: next(times))
    tuner.clear_memo()
    tc = tuner.tune_kernel("gpp", SMALL, device="cpu", measure_mode=True,
                           top_k=1, cache_dir=str(tmp_path / "tune"))
    assert tc.ranked == len(ranked) and len(tc.timings) == 2
    assert tc.config == static and tc.measured_s == 1.0
    assert k.finalize_config(tc.timings[0][0], "v10") != static


def test_corrupt_cache_is_ignored(tmp_path):
    cache = str(tmp_path / "tune")
    os.makedirs(cache)
    with open(os.path.join(cache, tuner.CACHE_FILE), "w") as fh:
        fh.write("{not json")
    tuner.clear_memo()
    tc = tuner.tune_kernel("gpp", SMALL, device="cpu", cache_dir=cache)
    assert tc.config.blk_ig > 0


def _fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=None: (9, 0))


def test_cpu_and_card_tags_never_collide(tmp_path, monkeypatch):
    cache = str(tmp_path / "tune")
    tuner.clear_memo()
    cpu = tuner.tune_kernel("gpp", problem.BENCH, device="cpu", cache_dir=cache)
    _fake_card(monkeypatch)
    tag = backend.device_tag("cuda")
    assert tag == "cuda:NVIDIA H100 80GB HBM3:sm90" and tag != "cpu"
    assert backend.device_tag("cpu") == "cpu"
    card = tuner.tune_kernel("gpp", problem.BENCH, device="cuda",
                             cache_dir=cache, measure_mode=False)
    assert card.source == "model"          # the CPU entry was not served
    assert card.key == f"gpp|512x64x64x2|{tag}|v10" != cpu.key
    on_disk = json.load(open(os.path.join(cache, tuner.CACHE_FILE)))
    assert set(on_disk) == {cpu.key, card.key}


def test_packages_keep_separate_cache_files(tmp_path):
    cache = str(tmp_path / "tune")
    tuner.clear_memo()
    jax_tuner.clear_memo()
    tc_t = tuner.tune_kernel("gpp", problem.BENCH, device="cpu", cache_dir=cache)
    tc_j = jax_tuner.tune(problem.BENCH, cache_dir=cache, measure_mode=False)
    assert tuner.CACHE_FILE != jax_tuner.CACHE_FILE
    torch_file = json.load(open(os.path.join(cache, tuner.CACHE_FILE)))
    jax_file = json.load(open(os.path.join(cache, jax_tuner.CACHE_FILE)))
    assert set(torch_file) == {tc_t.key} and set(jax_file) == {tc_j.key}
    # a fresh torch tuner still finds its own entry, not the JAX one
    tuner.clear_memo()
    again = tuner.tune_kernel("gpp", problem.BENCH, device="cpu", cache_dir=cache)
    assert again.source == "cache" and again.config == tc_t.config


def test_time_callable_honors_zero_warmup():
    calls = []
    measure.time_callable(lambda: calls.append(1), warmup=0, reps=2)
    assert len(calls) == 2
    calls.clear()
    measure.time_callable(lambda: calls.append(1), warmup=-3, reps=2)
    assert len(calls) == 2
    calls.clear()
    assert measure.time_callable(lambda: calls.append(1), warmup=1, reps=2) >= 0
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# journey
# ---------------------------------------------------------------------------

def test_journey_at_tiny_on_cpu():
    rows = run_journey("tiny", device="cpu", warmup=0, reps=1, verbose=False)
    assert [r.version for r in rows] == list(VERSIONS)
    for r in rows:
        assert r.rel_err < 1e-5, r.version
        assert r.device == "cpu" and r.size == "tiny"
        assert r.peak_share is None       # no device metric from a CPU run
        assert r.ms > 0 and r.tflops > 0
        assert (r.config is None) == (r.version in ("v0", "v1", "v2", "v3",
                                                    "v4", "v5"))
        assert r.version in format_row(r)
    assert rows[-1].config["name"] == "v10"


def test_journey_runs_the_versions_asked_for(capsys):
    rows = run_journey("tiny", device="cpu", warmup=0, reps=1,
                       versions=("v5", "v9"))
    assert [r.version for r in rows] == ["v5", "v9"]
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in printed] == ["v5", "v9"]
