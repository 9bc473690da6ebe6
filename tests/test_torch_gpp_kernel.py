"""The port's GPP kernels (repro_torch.kernels.gpp.gpp_cuda): the plain
versions against the JAX package's Pallas kernel in interpret mode at the
same blocks, layout and fusion, and against the complex128 oracle; the
Hopper BlockConfig's clamping, divisibility and limits. The CUDA kernels
themselves are held against these plain versions on a card by
tests/test_torch_gpp_cuda.py.

Tolerance: max-norm relative error `_rel` of tests/test_gpp_kernel.py,
RTOL 5e-5."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels.gpp import pallas_gpp as jpallas
from repro_torch.kernels.gpp import gpp_cuda, problem, ref

RTOL = 5e-5

SIZES = [  # tests/test_gpp_kernel.py's shapes
    problem.GppSize("s1", nbands=8, ngpown=8, ncouls=64),
    problem.GppSize("s2", nbands=16, ngpown=4, ncouls=128),
    problem.GppSize("s3", nbands=4, ngpown=16, ncouls=32),
]


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def _jax_cfg(cfg):
    return jpallas.BlockConfig(cfg.name, cfg.blk_ig, cfg.blk_igp, cfg.blk_band,
                               cfg.aqsm_transposed, fused_acc=cfg.fused_acc)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernel (interpret) and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: s.name)
@pytest.mark.parametrize("version", ["v6", "v7", "v8", "v9"])
def test_plain_matches_pallas_and_oracle(size, version):
    cfg = gpp_cuda.CONFIGS[version].clamped(size)
    inp = problem.make_inputs(size, seed=2)
    a, x = gpp_cuda.gpp_cuda(problem.to_tensors(inp, "cpu"), cfg)
    ja, jx = jpallas.gpp_pallas(inp, _jax_cfg(cfg), interpret=True)
    assert _rel(a, np.asarray(ja)) < RTOL
    assert _rel(x, np.asarray(jx)) < RTOL
    ach, asx = ref.ref_numpy(inp)
    assert _rel(a, ach) < RTOL
    assert _rel(x, asx) < RTOL


SWEEP = problem.GppSize("sw", nbands=16, ngpown=16, ncouls=64)
LAYOUTS = ((False, False), (True, False), (True, True))  # (transposed, fused)


def test_block_shape_sweep_vs_oracle():
    """test_pallas_block_shape_sweep's grid, through the plain versions."""
    inp = problem.make_inputs(SWEEP, seed=3)
    t = problem.to_tensors(inp, "cpu")
    ach, asx = ref.ref_numpy(inp)
    for blk_ig in (16, 32, 64):
        for blk_igp in (4, 16):
            for blk_band in (4, 8, 16):
                for tr, fused in LAYOUTS:
                    cfg = gpp_cuda.BlockConfig("t", blk_ig, blk_igp, blk_band,
                                               tr, fused_acc=fused)
                    a, x = gpp_cuda.gpp_cuda(t, cfg)
                    assert _rel(a, ach) < RTOL, cfg
                    assert _rel(x, asx) < RTOL, cfg


@pytest.mark.parametrize("tr,fused", LAYOUTS)
@pytest.mark.parametrize("blk_igp", [4, 16])
def test_block_shape_sweep_vs_pallas(blk_igp, tr, fused):
    inp = problem.make_inputs(SWEEP, seed=3)
    cfg = gpp_cuda.BlockConfig("t", 32, blk_igp, 8, tr, fused_acc=fused)
    a, x = gpp_cuda.gpp_cuda(problem.to_tensors(inp, "cpu"), cfg)
    ja, jx = jpallas.gpp_pallas(inp, _jax_cfg(cfg), interpret=True)
    assert _rel(a, np.asarray(ja)) < RTOL
    assert _rel(x, np.asarray(jx)) < RTOL


def test_partials_shapes_and_band_blocks_sum_to_fused():
    size = SWEEP
    t = problem.to_tensors(problem.make_inputs(size, seed=4), "cpu")
    cfg = gpp_cuda.BlockConfig("t", 16, 8, 4, True)
    banded = gpp_cuda.gpp_banded_plain(t, cfg)
    fused = gpp_cuda.gpp_fused_plain(t, dataclasses.replace(cfg, fused_acc=True))
    assert banded.shape == (2, 4, 4, 4, size.nw)
    assert fused.shape == (2, 4, 4, size.nw)
    assert _rel(banded.sum(2), fused.numpy()) < RTOL
    # the v6 layout reads the same values: identical partials
    v6 = gpp_cuda.gpp_banded_plain(t, dataclasses.replace(cfg, aqsm_transposed=False))
    assert torch.equal(v6, banded)


def test_wrappers_take_plain_version_on_cpu():
    t = problem.to_tensors(problem.make_inputs(problem.TINY, seed=1), "cpu")
    cfg = gpp_cuda.V9.clamped(problem.TINY)
    before = (gpp_cuda.gpp_fused.launches, gpp_cuda.gpp_banded.launches)
    assert torch.equal(gpp_cuda.gpp_fused(t, cfg), gpp_cuda.gpp_fused_plain(t, cfg))
    bcfg = gpp_cuda.V8.clamped(problem.TINY)
    assert torch.equal(gpp_cuda.gpp_banded(t, bcfg),
                       gpp_cuda.gpp_banded_plain(t, bcfg))
    assert (gpp_cuda.gpp_fused.launches, gpp_cuda.gpp_banded.launches) == before


def test_float64_plain_version_keeps_dtype():
    inp = problem.make_inputs(problem.TINY, seed=1)
    t64 = problem.to_tensors(inp, "cpu", torch.float64)
    p = gpp_cuda.gpp_fused_plain(t64, gpp_cuda.V9.clamped(problem.TINY))
    assert p.dtype == torch.float64
    s = p.sum((0, 1)).numpy()
    ach, asx = ref.ref_numpy(inp)
    assert _rel(s[0] + 1j * s[1], ach) < 1e-12
    assert _rel(s[2] + 1j * s[3], asx) < 1e-12


def test_shape_mismatch_raises():
    t = problem.to_tensors(problem.make_inputs(problem.TINY), "cpu")
    t["vcoul"] = t["vcoul"][:-1]
    with pytest.raises(ValueError):
        gpp_cuda.gpp_fused(t, gpp_cuda.V9.clamped(problem.TINY))


# ---------------------------------------------------------------------------
# BlockConfig: divisibility, clamping, Hopper limits, the journey steps
# ---------------------------------------------------------------------------

def test_divisibility_asserts_as_in_jax():
    inp = problem.make_inputs(problem.TINY)
    for blocks in ((48, 8, 8), (32, 3, 8), (32, 8, 3)):
        cfg = gpp_cuda.BlockConfig("bad", *blocks, True)
        with pytest.raises(AssertionError):
            jpallas.gpp_pallas(inp, _jax_cfg(cfg), interpret=True)
        with pytest.raises(AssertionError):
            gpp_cuda.gpp_cuda(problem.to_tensors(inp, "cpu"), cfg)


@pytest.mark.parametrize("size", SIZES + [problem.TINY, problem.BENCH],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("version", ["v6", "v7", "v8", "v9"])
def test_clamped_as_in_jax(size, version):
    cfg = gpp_cuda.CONFIGS[version]
    got = cfg.clamped(size)
    want = _jax_cfg(cfg).clamped(size)
    assert (got.blk_ig, got.blk_igp, got.blk_band) == \
        (want.blk_ig, want.blk_igp, want.blk_band)
    assert (got.aqsm_transposed, got.fused_acc) == \
        (want.aqsm_transposed, want.fused_acc)
    # and the thread count shrinks to whole warps covering the tile
    assert got.threads % 32 == 0 and got.threads <= cfg.threads
    assert got.threads < got.blk_ig * got.blk_igp + 32
    gpp_cuda.check_tiles(size, got)


def test_journey_configs_fit_hopper_and_step_one_thing_at_a_time():
    for cfg in gpp_cuda.CONFIGS.values():
        assert cfg.smem_bytes() <= gpp_cuda.SMEM_PER_BLOCK
        assert cfg.regs_estimate() <= gpp_cuda.REGS_PER_THREAD
        assert cfg.ept_instance() in gpp_cuda.EPT_INSTANCES
        gpp_cuda.check_tiles(problem.SI214, cfg)

    def fields(c, *skip):
        d = dataclasses.asdict(c)
        for k in ("name",) + skip:
            d.pop(k)
        return d

    v6, v7, v8, v9 = (gpp_cuda.CONFIGS[v] for v in ("v6", "v7", "v8", "v9"))
    assert not v6.aqsm_transposed and v7.aqsm_transposed
    assert fields(v6, "aqsm_transposed") == fields(v7, "aqsm_transposed")
    block_shape = ("blk_ig", "blk_igp", "blk_band", "threads")
    assert fields(v7, *block_shape) == fields(v8, *block_shape)
    assert not v8.fused_acc and v9.fused_acc
    assert fields(v8, "fused_acc") == fields(v9, "fused_acc")


def test_traffic_model():
    s = problem.SI214
    fused = gpp_cuda.hbm_traffic_model(s, gpp_cuda.V9)
    banded = gpp_cuda.hbm_traffic_model(s, gpp_cuda.V8)
    assert s.min_hbm_bytes() <= fused < banded
    # banded re-reads wtilde/eps once per band block: the traffic v9 removes
    n_b = s.nbands // gpp_cuda.V8.blk_band
    extra = (n_b - 1) * (16 * s.ncouls * s.ngpown
                         + 4 * s.ncouls * (s.ngpown // gpp_cuda.V8.blk_igp))
    blocks_out = 4 * 4 * s.nw * gpp_cuda.grid_blocks(s, gpp_cuda.V9) * (n_b - 1)
    assert banded - fused == pytest.approx(extra + blocks_out)
