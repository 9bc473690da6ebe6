"""The port's selective-scan kernel on a card: ssm_scan against its plain
version at hymba-1.5b's prefill shape under every config of the space,
batched and long shapes, ragged last time tiles, T < the time tile and
T = 1, N in {4, 8, 16} with every states a thread (N = 4 and 8 with a
channel on one lane), bf16 params, nonzero h0, C not a multiple of 4 (the
4-byte copies), bit-equal reruns, which path a CPU and a CUDA call take,
and what the wrapper refuses. Every test here needs a
CUDA card with sm_90a and skips without one; the file imports nothing of
jax, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm_cuda.py

Tolerance: y within Y_RTOL = 1e-5 of the largest |y| and hT within 1e-5
of the largest |hT|: both sides run the f32 recurrence in the same order
along T; the kernel uses expf and an FMA for the state update where the
plain version's exp and mul/add round separately, and it sums over N in
another order."""

import dataclasses

import pytest
import torch

from repro_torch.kernels import api
from repro_torch.kernels.ssm import ssm_cuda
from repro_torch.kernels.ssm.kernel_def import SsmKey
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


@pytest.mark.parametrize("b,t,c,n,states,blk,h0", [
    (4, 256, 3200, 16, 2, 16, 0.1),
    (2, 100, 48, 8, 4, 16, 0.1),        # a ragged last tile (100 = 64 + 36)
    (3, 33, 64, 4, 2, 64, 0.1),         # T < the 64-step tile
    (3, 33, 64, 4, 4, 8, 0.1),          # N = S = 4: one lane a channel
    (2, 130, 40, 8, 8, 8, 0.1),         # N = S = 8, 8 live lanes of 32
    (1, 1, 64, 16, 4, 16, 0.1),         # T = 1
    (2, 77, 24, 16, 8, 8, 0.1),         # 16 live lanes of a 32-lane warp
    (1, 70, 36, 16, 4, 6, 0.1),         # blk_c 6: 4-byte x/dt copies
    (1, 200, 30, 8, 2, 30, 0.0),        # C not a multiple of 4
    (1, 4096, 3200, 16, 4, 8, 0.0),     # long: 64 tiles through the ring
])
def test_kernel_matches_plain(cuda, b, t, c, n, states, blk, h0):
    _check(_inputs(cuda, b, t, c, n, h0_scale=h0),
           SsmScanConfig("t", blk, states))


def test_every_config_of_the_space(cuda):
    """hymba-1.5b's prefill (B=1, T=1152, C=3200, N=16) under every config
    the tuner may pick."""
    key = SsmKey(b=1, t=1152, c=3200, n=16)
    args = _inputs(cuda, 1, 1152, 3200, 16, seed=3)
    space = api.get_kernel("ssm").config_space(key, "cuda")
    assert len(space) >= 6
    for cfg in space:
        _check(args, cfg)


def test_reruns_bit_equal(cuda):
    args = _inputs(cuda, 2, 300, 256, 16, seed=4, h0_scale=0.1)
    for cfg in (SsmScanConfig(), SsmScanConfig("t", 16, 4),
                SsmScanConfig("t", 32, 8)):
        y1, h1 = ssm_cuda.ssm_scan(*args, cfg)
        y2, h2 = ssm_cuda.ssm_scan(*args, cfg)
        assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
        assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))


def test_paths_by_device(cuda, monkeypatch):
    """A CUDA call launches the kernel and never reaches ssm_scan_plain; a
    CPU call takes the plain version and never launches."""
    plain_calls = []
    real_plain = ssm_cuda.ssm_scan_plain

    def spy(*a, **kw):
        plain_calls.append(a[0].device.type)
        return real_plain(*a, **kw)

    monkeypatch.setattr(ssm_cuda, "ssm_scan_plain", spy)
    args = _inputs(cuda, 1, 40, 64, 16, seed=5)
    before = ssm_cuda.ssm_scan.launches
    y, _ = ssm_cuda.ssm_scan(*args)
    assert y.device.type == "cuda" and plain_calls == []
    assert ssm_cuda.ssm_scan.launches == before + 1
    y, _ = ssm_cuda.ssm_scan(*(a.cpu() for a in args))
    assert y.device.type == "cpu" and plain_calls == ["cpu"]
    assert ssm_cuda.ssm_scan.launches == before + 1


def test_bf16_params(cuda):
    for states in ssm_cuda.STATE_INSTANCES:
        _check(_inputs(cuda, 2, 130, 256, 16, seed=1, h0_scale=0.1,
                       bf16_params=True), SsmScanConfig("t", 8, states))


def test_counter_and_refusals(cuda):
    args = _inputs(cuda, 1, 16, 32, 16)
    before = ssm_cuda.ssm_scan.launches
    ssm_cuda.ssm_scan(*args)
    assert ssm_cuda.ssm_scan.launches == before + 1
    with pytest.raises(ValueError):          # N not compiled
        ssm_cuda.ssm_scan(*_inputs(cuda, 1, 16, 32, 2))
    with pytest.raises(ValueError):          # blk_c does not tile C
        ssm_cuda.ssm_scan(*args, SsmScanConfig("t", 12))
    with pytest.raises(ValueError):          # states not compiled
        ssm_cuda.ssm_scan(*args, SsmScanConfig("t", 8, 16))
    with pytest.raises(ValueError):          # 64 x 8 lanes: 512 threads > 256
        ssm_cuda.ssm_scan(*_inputs(cuda, 1, 16, 64, 16),
                          SsmScanConfig("t", 64, 2))
    with pytest.raises(ValueError):          # a strided view
        bad = list(args)
        bad[0] = torch.randn(1, 32, 16, device=cuda).transpose(1, 2)
        ssm_cuda.ssm_scan(*bad)
    with pytest.raises(ValueError):          # f64 state
        bad = list(args)
        bad[6] = bad[6].double()
        ssm_cuda.ssm_scan(*bad)
    with pytest.raises(ValueError):          # b off a 16-byte boundary
        bad = list(args)
        bad[2] = torch.randn(1 * 16 * 16 + 1, device=cuda)[1:].view(1, 16, 16)
        ssm_cuda.ssm_scan(*bad)
    assert ssm_cuda.ssm_scan.launches == before + 1


def test_old_cache_entry_launches(cuda):
    """A tune-cache entry from before `states` (blk_c alone) launches."""
    cfg = api.get_kernel("ssm").config_from_json({"name": "cuda", "blk_c": 16})
    assert cfg == dataclasses.replace(SsmScanConfig(), name="cuda", blk_c=16)
    _check(_inputs(cuda, 1, 64, 3200, 16, seed=6), cfg)


def test_compiled_instances(cuda):
    for n, states in ssm_cuda.instances():
        for bf16 in (False, True):
            regs, spill = ssm_cuda.kernel_attrs(n, states, bf16)
            assert 0 < regs <= 255 and spill == 0, (n, states, bf16, regs,
                                                    spill)
