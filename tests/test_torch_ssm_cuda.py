"""The port's selective-scan kernel on a card: ssm_scan against its plain
version at hymba-1.5b's prefill shape, batched and long shapes, a ragged
last time tile, N in {4, 8, 16}, bf16 params, nonzero h0, blk_c values of
the config space, and what the wrapper refuses. Every test here needs a
CUDA card with sm_90a and skips without one; the file imports nothing of
jax, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm_cuda.py

Tolerance: y within Y_RTOL = 1e-5 of the largest |y| and hT within 1e-5
of the largest |hT|: both sides run the f32 recurrence in the same order
along T; the kernel uses expf and an FMA for the state update where the
plain version's exp and mul/add round separately, and it sums over N in
another order."""

import pytest
import torch

from repro_torch.kernels.ssm import ssm_cuda
from repro_torch.kernels.ssm.ssm_cuda import SsmScanConfig

pytestmark = pytest.mark.cuda

Y_RTOL = 1e-5


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    return torch.device("cuda")


def _inputs(dev, b, t, c, n, seed=0, h0_scale=0.0, bf16_params=False):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = rnd(b, t, c)
    dt = torch.nn.functional.softplus(rnd(b, t, c) - 2)
    bm, cm = rnd(b, t, n), rnd(b, t, n)
    alog = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                  device=dev))[None].repeat(c, 1)
    d = rnd(c)
    h0 = h0_scale * rnd(b, c, n)
    if bf16_params:
        alog, d = alog.to(torch.bfloat16), d.to(torch.bfloat16)
    return x, dt, bm, cm, alog, d, h0


def _check(args, cfg):
    y, h = ssm_cuda.ssm_scan(*args, cfg)
    torch.cuda.synchronize()
    py, ph = ssm_cuda.ssm_scan_plain(*args, cfg)
    assert y.shape == py.shape and h.shape == ph.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    assert float((y - py).abs().max()) <= Y_RTOL * float(py.abs().max())
    assert float((h - ph).abs().max()) <= Y_RTOL * float(ph.abs().max())


@pytest.mark.parametrize("b,t,c,n,blk,h0", [
    (1, 1152, 3200, 16, 16, 0.0),       # hymba-1.5b's prefill
    (4, 256, 3200, 16, 2, 0.1),
    (2, 100, 48, 8, 16, 0.1),           # a ragged last tile (100 = 64 + 36)
    (3, 33, 64, 4, 64, 0.1),
    (1, 64, 40, 16, 1, 0.1),            # 16 live lanes of a 32-lane warp
])
def test_kernel_matches_plain(cuda, b, t, c, n, blk, h0):
    _check(_inputs(cuda, b, t, c, n, h0_scale=h0), SsmScanConfig("t", blk))


def test_bf16_params(cuda):
    _check(_inputs(cuda, 2, 130, 256, 16, seed=1, h0_scale=0.1,
                   bf16_params=True), SsmScanConfig())


def test_counter_and_refusals(cuda):
    args = _inputs(cuda, 1, 16, 32, 16)
    before = ssm_cuda.ssm_scan.launches
    ssm_cuda.ssm_scan(*args)
    assert ssm_cuda.ssm_scan.launches == before + 1
    with pytest.raises(ValueError):          # N not compiled
        ssm_cuda.ssm_scan(*_inputs(cuda, 1, 16, 32, 2))
    with pytest.raises(ValueError):          # blk_c does not tile C
        ssm_cuda.ssm_scan(*args, SsmScanConfig("t", 12))
    with pytest.raises(ValueError):          # a strided view
        bad = list(args)
        bad[0] = torch.randn(1, 32, 16, device=cuda).transpose(1, 2)
        ssm_cuda.ssm_scan(*bad)
    with pytest.raises(ValueError):          # f64 state
        bad = list(args)
        bad[6] = bad[6].double()
        ssm_cuda.ssm_scan(*bad)
    assert ssm_cuda.ssm_scan.launches == before + 1


def test_compiled_instances(cuda):
    for n in ssm_cuda.N_INSTANCES:
        for bf16 in (False, True):
            regs, spill = ssm_cuda.kernel_attrs(n, bf16)
            assert 0 < regs <= 64 and spill == 0, (n, bf16, regs, spill)
