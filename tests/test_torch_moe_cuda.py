"""The moe family on a card: `moe_ffn` bit-equal over two runs and
against its CPU run where the routing is settled (`moe.settled`, as
chip_smoke.py's phase 14b), at a prefill and a decode shape; a reduced
deepseek-moe-16b whose prefill, decode steps and served greedy tokens are
bit-equal over two runs on the card, and whose paged engine serves the
unpaged engine's tokens. Every test here needs a CUDA card and skips
without one; the file imports nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Tolerances (the card against the CPU): gather_idx equal and gates within
GATE_ATOL = 1e-5 on experts whose picks no change below MARGIN = 1e-4 in
the router's inputs can move, the output within OUT_ULPS = 2 bf16 ulps
of the largest |out| on tokens whose routing is settled (the f32 router
GEMM and the bf16 expert products sum in another order on the card)."""

import numpy as np
import pytest
import torch

from repro_torch import backend
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

MARGIN = 1e-4
GATE_ATOL = 1e-5
OUT_ULPS = 2


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _layer(e, d, f, seed=0):
    """One moe layer's params at the 0.02 init; the router at 0.04, so its
    logits on N(0, 1) inputs spread as deepseek's do at d_model 2048
    (std ~0.9)."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, scale=0.02):
        return (scale * torch.randn(shape, generator=g)).to(torch.bfloat16)

    return {"router": w(d, e, scale=0.04), "wi": w(e, d, f),
            "wg": w(e, d, f), "wo": w(e, f, d), "shared_wi": w(d, 2 * f),
            "shared_wg": w(d, 2 * f), "shared_wo": w(2 * f, d)}


@pytest.mark.parametrize("t", [512, 4])
def test_moe_ffn_rerun_bit_equal_and_against_the_cpu(cuda, t):
    e, k, d, f = 64, 6, 512, 256
    layer = _layer(e, d, f)
    x = torch.randn((t, d), generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    on_card = {n: w.to(cuda) for n, w in layer.items()}
    runs = []
    with backend.f32_accumulation():
        for _ in range(2):
            out, aux = moe.moe_ffn(x.to(cuda), on_card, n_experts=e, k=k)
            gate, idx, _, _ = moe.dispatch(x.to(cuda), on_card["router"],
                                           n_experts=e, k=k)
            runs.append((out.cpu(), aux.cpu(), {"gather_idx": idx.cpu(),
                                                "gate": gate.cpu()}))
    (o1, a1, d1), (o2, a2, d2) = runs
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(a1, a2)
    for key in ("gather_idx", "gate"):
        assert torch.equal(d1[key], d2[key])
    oc, ac = moe.moe_ffn(x, layer, n_experts=e, k=k)
    gate, idx, _, _ = moe.dispatch(x, layer["router"], n_experts=e, k=k)
    dc = {"gather_idx": idx, "gate": gate}
    picks, tokens = moe.settled(x, layer["router"], dc["gate"], n_experts=e,
                                k=k, margin=MARGIN)
    assert 4 * int(picks.sum()) >= e and 2 * int(tokens.sum()) >= t
    gi, oi = d1["gather_idx"].sort(-1)
    gp, op = dc["gather_idx"].sort(-1)
    assert torch.equal(gi[picks], gp[picks])
    assert float((d1["gate"].gather(-1, oi)[picks]
                  - dc["gate"].gather(-1, op)[picks]).abs().max()) \
        <= GATE_ATOL
    want = oc.float()[tokens]
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((o1.float()[tokens] - want).abs().max()) <= OUT_ULPS * ulp
    assert float(a1) == pytest.approx(float(ac), rel=1e-5)


def test_reduced_deepseek_is_deterministic_on_the_card(cuda):
    """Prefill and three decode steps twice on one card: logits and every
    cache leaf bit-equal; the engine's greedy tokens bit-equal over two
    runs, and the paged engine's equal to them."""
    cfg = reduce_config(get_config("deepseek-moe-16b"), layers=3, d_model=256,
                        vocab=512)
    model = build_model(cfg)
    params = model.init_params(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 48))).to(cuda)
    outs = []
    for _ in range(2):
        logits, cache = model.prefill(params, {"tokens": toks})
        cache = {n: v if n == "pos" else torch.nn.functional.pad(
            v, (0, 0, 0, 0, 0, 4)) for n, v in cache.items()}
        steps = [logits]
        feed = toks[:, -1:]
        for _ in range(3):
            logits, cache = model.decode_step(params, cache, feed)
            steps.append(logits)
            feed = logits.argmax(-1)
        outs.append((steps, cache))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    for n in outs[0][1]:
        assert torch.equal(outs[0][1][n], outs[1][1][n]), n
    assert all(bool(torch.isfinite(s).all()) for s in outs[0][0])
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n), max_new_tokens=8)
            for i, n in enumerate((5, 17, 33, 9, 24))]
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64, device=cuda)
    first = eng.run(reqs)
    assert eng.run(reqs) == first
    paged = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                        kv_page_size=8, device=cuda)
    assert paged.run(reqs) == first
    paged.kv.check_conservation()
