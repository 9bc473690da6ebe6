"""The encdec (whisper) and vlm (internvl2) families on a card: a reduced
whisper-small (2 + 2 layers, d_model 64, vocab 128, enc_seq 64) whose
prefill, loss and gradients with f32 frames on the card agree with the
same code's CPU run (the encoder's projections multiply f32 activations
by bf16 weights: layers.matmul's mixed-dtype branch), whose served greedy
tokens are bit-equal over two runs and through the paged cache; and a
reduced internvl2-26b with flash on, whose prefill and training step at
S = 256 (8 vis + 248 text) launch the flash kernels, every launch held
against its plain version on its own inputs. Every test here needs a
CUDA card and skips without one; the file imports nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_encdec_vlm_cuda.py

Tolerances: the mixed-dtype matmul within MATMUL_ULPS = 1 bf16 ulp of
each value's magnitude (both round one f32 product, summed in another
order); logits within LOGIT_ATOL = 2e-2, the loss within LOSS_ATOL =
5e-3 and every gradient leaf within GRAD_RTOL = 3e-2 of its largest |CPU
grad| (tests/test_torch_rwkv_cuda.py's bounds); flash_fwd within
FLASH_OUT_ULPS = 2 bf16 ulps of each value's magnitude and the backward
kernels within BWD_ULPS = 1 bf16 ulp at their largest element
(chip_smoke.py's gates)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.kernels.flash import flash_cuda
from repro_torch.models import layers
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

MATMUL_ULPS = 1.0
LOGIT_ATOL = 2e-2
LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
FLASH_OUT_ULPS = 2.0
BWD_ULPS = 1.0
KW = dict(layers=2, d_model=64, vocab=128)


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(arch, **kw):
    cfg = dataclasses.replace(reduce_config(get_config(arch), **KW), **kw)
    return cfg, build_model(cfg), build_model(cfg).init_params(0,
                                                               device="cpu")


def _tokens(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 128, shape))


def _frames(b, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((b, 64, 64), generator=g) * 0.02).to(dtype)


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of max(|want|, 1% of max)."""
    want = want.float()
    scale = want.abs().clamp_min(float(want.abs().max()) * 1e-2)
    return float(((got.float() - want).abs() / scale).max()) * 2 ** 7


def _ulps_at_max(got, want):
    """Largest |got - want| in bf16 ulps at the largest |want|."""
    import math
    want = want.float()
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got.float() - want).abs().max()) / ulp


def test_mixed_dtype_matmul_card_against_cpu(cuda):
    """An f32 activation times a bf16 weight: an f32 product rounded once
    to bf16, on the card (cuBLAS in f32, TF32 off) as on the CPU."""
    from repro_torch import backend
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 50, 768), generator=g)
    w = (torch.randn((768, 3072), generator=g) * 0.02).bfloat16()
    want = layers.matmul(x, w)
    with backend.f32_accumulation():
        got = layers.matmul(x.to(cuda), w.to(cuda))
    assert got.dtype == want.dtype == torch.bfloat16
    assert _ulps(got.cpu(), want) <= MATMUL_ULPS


@pytest.mark.parametrize("xd, wd", [(torch.bfloat16, torch.float32),
                                    (torch.float16, torch.bfloat16)])
def test_other_mixed_dtype_matmul_raises_on_the_card(cuda, xd, wd):
    """Only an f32 activation may meet a bf16 weight on the card; any
    other pair of types raises rather than running an f32 product."""
    x = torch.ones((2, 8), dtype=xd, device=cuda)
    w = torch.ones((8, 4), dtype=wd, device=cuda)
    with pytest.raises(TypeError, match="only an f32 activation"):
        layers.matmul(x, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_prefill_loss_and_grads_card_against_cpu(cuda, dtype):
    """Prefill logits and xk/xv, then loss_fn and every gradient, with f32
    and bf16 frames, the card against the CPU."""
    _, model, params = _model("whisper-small")
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = _tokens((2, 33), seed=1)
    fr = _frames(2, seed=1, dtype=dtype)
    lc, cc = model.prefill(params, {"tokens": toks[:, :20], "frames": fr})
    lg, cg = model.prefill(on_card, {"tokens": toks[:, :20].to(cuda),
                                     "frames": fr.to(cuda)})
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=LOGIT_ATOL,
                               rtol=0)
    for key in ("xk", "xv"):
        assert _ulps_at_max(cg[key].cpu(), cc[key]) <= 2.0, key
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": fr}
    runs = []
    for p, dev in ((params, "cpu"), (on_card, cuda)):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        leaves = tree_leaves(p)
        total, met = model.loss_fn(p, {k: v.to(dev) for k, v in
                                       batch.items()})
        runs.append((float(met["loss"].detach()),
                     torch.autograd.grad(total, leaves)))
    (loss_c, gc), (loss_g, gg) = runs
    assert abs(loss_g - loss_c) <= LOSS_ATOL
    for a, b in zip(gg, gc):
        assert torch.isfinite(a).all()
        err = float((a.cpu().float() - b.float()).abs().max())
        assert err <= GRAD_RTOL * float(b.float().abs().max())


def test_whisper_engine_reruns_and_pages_bit_equal(cuda):
    """Greedy tokens on the card: two runs bit-equal, kv_page_size 8 equal
    to unpaged; f32 and bf16 frames in Request.extra."""
    cfg, _, params = _model("whisper-small")
    reqs = [Request(rid=i, prompt=_tokens((n,), seed=i).numpy(),
                    max_new_tokens=6,
                    extra={"frames": _frames(1, seed=i, dtype=(
                        torch.float32 if i % 2 else torch.bfloat16))})
            for i, n in enumerate((5, 12, 9, 20))]
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=32, device=cuda)
    first = eng.run(reqs)
    assert eng.run(reqs) == first
    paged = ServeEngine(cfg, params, max_batch=2, cache_len=32,
                        kv_page_size=8, device=cuda)
    assert paged.run(reqs) == first


def _held(monkeypatch, errs):
    """Every flash kernel launch checked against its plain version on its
    own inputs; errs[name] collects each launch's distance."""
    plain = {"flash_fwd": flash_cuda.flash_fwd_plain,
             "flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}
    for name, ref in plain.items():
        real = getattr(flash_cuda, name)

        def call(*args, real=real, ref=ref, name=name):
            out = real(*args)
            want = ref(*args)
            if name == "flash_fwd":
                errs[name].append(_ulps(out[0], want[0]))
            else:
                pairs = zip(out, want) if isinstance(out, tuple) else \
                    [(out, want)]
                errs[name].append(max(_ulps_at_max(g, w) for g, w in pairs))
            return out

        call.launches = 0
        monkeypatch.setattr(flash_cuda, name, call)


def test_internvl2_flash_launches_held_to_plain(cuda, monkeypatch):
    """use_flash_attention at S = 256 (8 vis + 248 text): a prefill
    launches flash_fwd once a layer; a loss and its gradients launch
    flash_fwd, flash_bwd_dq and flash_bwd_dkv once a layer each (remat
    "none"); every launch within its gate of the plain version; the
    prefill's logits within LOGIT_ATOL of the CPU's."""
    cfg, model, params = _model("internvl2-26b", use_flash_attention=True)
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = _tokens((2, 249), seed=3)
    g = torch.Generator().manual_seed(3)
    vis = torch.randn((2, cfg.n_vis_tokens, 64), generator=g)
    lc, _ = model.prefill(params, {"tokens": toks[:, :-1], "vis": vis})
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    _held(monkeypatch, errs)
    lg, _ = model.prefill(on_card, {"tokens": toks[:, :-1].to(cuda),
                                    "vis": vis.to(cuda)})
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=LOGIT_ATOL,
                               rtol=0)
    assert len(errs["flash_fwd"]) == cfg.n_layers
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), on_card)
    total, _ = model.loss_fn(p, {"tokens": toks[:, :-1].to(cuda),
                                 "labels": toks[:, 1:].to(cuda),
                                 "vis": vis.to(cuda)})
    torch.autograd.grad(total, tree_leaves(p))
    assert {n: len(e) for n, e in errs.items()} == {
        "flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
        "flash_bwd_dkv": cfg.n_layers}
    assert max(errs["flash_fwd"]) <= FLASH_OUT_ULPS
    assert max(errs["flash_bwd_dq"] + errs["flash_bwd_dkv"]) <= BWD_ULPS
