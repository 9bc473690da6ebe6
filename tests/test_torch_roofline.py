"""The port's roofline (`repro_torch.core.roofline`), the card's machine
balance (`core.hw`) and the census's eager traffic (`analyze.census`'s
op_bytes and launches), held to the JAX package on the CPU.

  * `analyze_counts` and `format_table` against JAX's on the same counts,
    on a GpuSpec carrying TPU v5e's numbers (the tensor cores at the MXU's
    rate, FP32 at the VPU's, NVLink at ICI's): every row() value within
    1e-12 relative and the same dominant term; the same table;
  * the reference's report invariants (tests/test_core_roofline.py);
  * the machine balance and the paper's 5.3 TFLOP/s FMA ceiling;
  * op_bytes >= hbm_bytes for every gpp version at TINY.
"""

import math

import numpy as np
import pytest
from _prop import given, settings, st

from repro.core import roofline as jroofline
from repro.core.hw import TPU_V5E
from repro_torch.analyze.census import census_kernel
from repro_torch.core import hw, roofline
from repro_torch.kernels.gpp import problem

V5E_AS_GPU = hw.GpuSpec(
    name="v5e-numbers", part="TPU v5e's rates in a GpuSpec", sms=1,
    boost_hz=1.0, fp32_flops=TPU_V5E.vpu_flops, hbm_bw=TPU_V5E.hbm_bw,
    bf16_tc_flops=TPU_V5E.mxu_flops, link_bw=TPU_V5E.ici_bw,
    memory_bytes=TPU_V5E.hbm_bytes)

# the port's names for the reference's MXU columns
RENAMED = {"mxu_frac": "tc_frac"}

COUNTS = [
    dict(flops=1e12, hbm_bytes=1e9),
    dict(flops=3e15, hbm_bytes=2e11, collective_bytes=5e10,
         tc_flops=2.5e15, mesh_shape=(4, 2), model_flops_total=2.4e16),
    dict(flops=7e9, hbm_bytes=4e10, collective_bytes=1e8, tc_flops=0.0),
    dict(flops=2e13, hbm_bytes=1e8, collective_bytes=9e11, tc_flops=1e13,
         mesh_shape=(2, 16, 16)),
]


def _rel_close(a, b):
    if a is None or b is None or isinstance(a, str):
        return a == b
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


@pytest.mark.parametrize("counts", COUNTS)
def test_analyze_counts_matches_jax(counts):
    jkw = dict(counts)
    if "tc_flops" in jkw:
        jkw["mxu_flops"] = jkw.pop("tc_flops")
    want = jroofline.analyze_counts("cell", hw=TPU_V5E, **jkw)
    got = roofline.analyze_counts("cell", spec=V5E_AS_GPU, **counts)
    assert got.dominant == want.dominant
    want_row = {RENAMED.get(k, k): v for k, v in want.row().items()}
    assert set(got.row()) == set(want_row)
    for k, v in got.row().items():
        assert _rel_close(v, want_row[k]), (k, v, want_row[k])
    assert _rel_close(got.customized_peak_flops, want.customized_peak_flops)
    assert _rel_close(got.customized_fraction, want.customized_fraction)
    assert _rel_close(got.modeled_step_s_noverlap,
                      want.modeled_step_s_noverlap)
    assert _rel_close(got.extra["tc_peak_compute_s"],
                      want.extra["mxu_peak_compute_s"])


def test_format_table_matches_jax():
    want = [jroofline.analyze_counts(
        f"c{i}", hw=TPU_V5E,
        **{("mxu_flops" if k == "tc_flops" else k): v
           for k, v in c.items()}) for i, c in enumerate(COUNTS)]
    got = [roofline.analyze_counts(f"c{i}", spec=V5E_AS_GPU, **c)
           for i, c in enumerate(COUNTS)]
    assert roofline.format_table(got) == \
        jroofline.format_table(want).replace("| mxu% |", "| tc% |")


def test_smem_level_in_extra():
    rep = roofline.analyze_counts("x", flops=9e12, hbm_bytes=1e9,
                                  smem_bytes=1e12)
    assert rep.extra["smem_bytes"] == 1e12 and rep.extra["ai_smem"] == 9.0
    assert rep.extra["ai_hbm"] == 9e3
    rep = roofline.analyze_counts("y", flops=1.0, hbm_bytes=4.0)
    assert rep.extra["ai_smem"] is None and rep.extra["ai_hbm"] == 0.25


@settings(max_examples=20, deadline=None)
@given(flops=st.floats(1e6, 1e15), nbytes=st.floats(1e3, 1e13),
       coll=st.floats(0, 1e12), tc=st.floats(0, 1.0))
def test_report_invariants(flops, nbytes, coll, tc):
    spec = hw.H100_SXM5
    rep = roofline.analyze_counts(
        "t", flops=flops, hbm_bytes=nbytes, collective_bytes=coll,
        tc_flops=tc * flops, mesh_shape=(4, 2), spec=spec)
    assert rep.chips == 8
    assert rep.modeled_step_s == max(rep.compute_s, rep.memory_s,
                                     rep.collective_s)
    assert 0 <= rep.roofline_fraction <= 1.0 + 1e-9
    assert rep.dominant in ("compute", "memory", "collective")
    # the customized ceiling lies between the FP32 and tensor-core peaks
    assert spec.fp32_flops * (1 - 1e-9) <= rep.customized_peak_flops \
        <= spec.bf16_tc_flops * (1 + 1e-9)
    # achieved never exceeds the customized ceiling
    ach = rep.flops_per_chip / rep.modeled_step_s
    assert ach <= rep.customized_peak_flops * (1 + 1e-6)
    assert rep.collective_s == coll / spec.link_bw


def test_machine_balance():
    s = hw.H100_SXM5
    assert s.machine_balance == 989e12 / 3.35e12          # ~295 FLOP/B
    assert round(s.machine_balance) == 295
    assert s.fp32_machine_balance == 67e12 / 3.35e12      # 20 FLOP/B
    assert round(s.fp32_machine_balance) == 20
    assert hw.H100_PCIE.fp32_machine_balance == 51e12 / 2.0e12
    assert (s.link_bw, hw.H100_PCIE.link_bw) == (900e9, 600e9)
    # the reference's definitions on the same rates
    assert V5E_AS_GPU.machine_balance == TPU_V5E.machine_balance
    assert V5E_AS_GPU.fp32_machine_balance == TPU_V5E.vpu_machine_balance


def test_fma_ceiling_paper_example():
    """The paper: a 58% FMA instruction ratio attains (2 x .58 + .42) / 2
    = 79% of the V100's 6.7 TFLOP/s, 5.3 TFLOP/s. The port's fma_ceiling
    on a V100-rate spec gives it, and agrees with the reference's
    two-rate ceiling at P_fma = 2 P_other (tests/test_core_roofline.py)."""
    v100 = hw.GpuSpec(name="v100", part="V100 FP64 rates", sms=80,
                      boost_hz=1.312e9, fp32_flops=6.7e12, hbm_bw=900e9,
                      bf16_tc_flops=6.7e12, link_bw=300e9,
                      memory_bytes=16 * 2 ** 30)
    r = 0.58
    f = roofline.fma_flop_fraction(r)
    assert f == pytest.approx(2 * r / (r + 1))
    ceiling = roofline.fma_ceiling(f, v100)
    expected = (2 * r + (1 - r)) / 2 * 6.7e12
    np.testing.assert_allclose(ceiling, expected, rtol=1e-12)
    np.testing.assert_allclose(ceiling, 5.3e12, rtol=0.01)
    two_rate = hw.GpuSpec(name="v100-2", part="FMA and other", sms=80,
                          boost_hz=1.312e9, fp32_flops=3.35e12,
                          hbm_bw=900e9, bf16_tc_flops=6.7e12, link_bw=300e9,
                          memory_bytes=16 * 2 ** 30)
    np.testing.assert_allclose(
        roofline.customized_ceiling(100.0, 100.0 * f, two_rate), ceiling,
        rtol=1e-12)
    # the H100: gpp_fused's SASS FMA ratio 0.462
    np.testing.assert_allclose(
        roofline.fma_ceiling(roofline.fma_flop_fraction(24 / 52)),
        67e12 / (2 - 48 / 76), rtol=1e-12)


@pytest.mark.parametrize("version", ["v0", "v1", "v2", "v3", "v4", "v5",
                                     "v6", "v7", "v8", "v9", "v10"])
def test_op_bytes_at_least_compulsory(version):
    c = census_kernel("gpp", version, problem.TINY, device="cpu")
    assert c.op_bytes >= c.hbm_bytes > 0
    assert c.launches > 0
    # every arithmetic op is a launch: far more launches than the loops
    assert c.launches > problem.TINY.nbands
