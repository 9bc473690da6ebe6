"""The ssm family (rwkv6) and hybrid training on a card: a reduced
rwkv6-7b (2 layers, d_model 64, two heads of 32, vocab 128) whose
prefill, decode steps, loss and gradients on the card agree with the
same code's CPU run, whose served greedy tokens are bit-equal over two
runs on the card; and a reduced hymba-1.5b with ssm_impl="pallas" whose
training forward launches the scan kernel and whose backward raises (the
kernel has none). Every test here needs a CUDA card and skips without
one; the file imports nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv_cuda.py

Tolerances (the card against the CPU): logits within LOGIT_ATOL = 2e-2,
as tests/test_torch_model.py holds the port to JAX (bf16 activations: a
product summed in another order can round one bf16 ulp apart, and that
propagates); the wkv state within WKV_RTOL = 2e-2 of its largest value;
the loss within LOSS_ATOL = 5e-3 and every gradient leaf within
GRAD_RTOL = 3e-2 of its largest |CPU grad| (tests/test_torch_train.py's
bounds)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.kernels.ssm import ssm_cuda
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

LOGIT_ATOL = 2e-2
WKV_RTOL = 2e-2
LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
KW = dict(layers=2, d_model=64, vocab=128)


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rwkv():
    cfg = reduce_config(get_config("rwkv6-7b"), **KW)
    return cfg, build_model(cfg), build_model(cfg).init_params(0,
                                                               device="cpu")


def _tokens(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 128, shape))


@pytest.mark.parametrize("s", [40, 64, 70, 128])
def test_prefill_and_decode_card_against_cpu(cuda, s):
    """S = 40 (one chunk), 64 and 128 (64-step chunks) and 70 (the
    sequential scan); then three decode steps fed the CPU's greedy
    tokens."""
    _, model, params = _rwkv()
    on_card = tree_map(lambda t: t.to(cuda), params)
    toks = _tokens((2, s), seed=s)
    lc, cc = model.prefill(params, {"tokens": toks})
    lg, cg = model.prefill(on_card, {"tokens": toks.to(cuda)})
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=LOGIT_ATOL,
                               rtol=0)
    err = float((cg["wkv"].cpu() - cc["wkv"]).abs().max())
    assert err <= WKV_RTOL * float(cc["wkv"].abs().max())
    feed = lc.argmax(-1)
    for _ in range(3):
        lc, cc = model.decode_step(params, cc, feed)
        lg, cg = model.decode_step(on_card, cg, feed.to(cuda))
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(),
                                   atol=LOGIT_ATOL, rtol=0)
        feed = lc.argmax(-1)
    assert int(cg["pos"]) == s + 3


def test_loss_and_grads_card_against_cpu(cuda):
    """loss_fn at T = 128 (past the -60 clamp at the initial decay) and
    every gradient leaf, finite on the card."""
    cfg, model, params = _rwkv()
    cfg = dataclasses.replace(cfg, remat="full")
    model = build_model(cfg)
    toks = _tokens((2, 129), seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                     params)
        total, _ = model.loss_fn(p, {k: v.to(dev) for k, v in batch.items()})
        runs.append((float(total.detach()), [g.float().cpu() for g in
                                    torch.autograd.grad(total,
                                                        tree_leaves(p))]))
    (lc, gc), (lg, gg) = runs
    assert abs(lg - lc) <= LOSS_ATOL
    for a, b in zip(gg, gc):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= GRAD_RTOL * float(b.abs().max())


def test_served_tokens_rerun_bit_equal(cuda):
    """Greedy requests through the slot engine on the card (exact-length
    prompts on each WKV path): two runs emit the same tokens."""
    cfg, _, params = _rwkv()
    on_card = tree_map(lambda t: t.to(cuda), params)
    reqs = [Request(rid=i, prompt=np.arange(n) % 128, max_new_tokens=6)
            for i, n in enumerate((5, 40, 64, 70))]
    outs = [ServeEngine(cfg, on_card, max_batch=2, cache_len=128,
                        device=cuda).run(reqs) for _ in range(2)]
    assert outs[0] == outs[1]
    assert all(len(t) == 6 for t in outs[0].values())


def test_pallas_backward_raises_on_the_card(cuda):
    """Hybrid training with ssm_impl="pallas": the forward launches the scan
    kernel once a layer, the backward raises NotImplementedError."""
    cfg = dataclasses.replace(
        reduce_config(get_config("hymba-1.5b"), **KW), ssm_impl="pallas")
    params = tree_map(lambda t: t.requires_grad_(True),
                      build_model(cfg).init_params(0, device=cuda))
    toks = _tokens((2, 129), seed=2).to(cuda)
    ssm_cuda.ssm_scan.launches = 0
    total, _ = build_model(cfg).loss_fn(
        params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert ssm_cuda.ssm_scan.launches == cfg.n_layers
    assert torch.isfinite(total)
    with pytest.raises(NotImplementedError, match="has no backward"):
        torch.autograd.grad(total, tree_leaves(params))
