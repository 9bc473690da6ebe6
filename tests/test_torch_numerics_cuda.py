"""The port's f32-accumulation contract on a card, with PyTorch's default
matmul flags left on (allow_bf16_reduced_precision_reduction True,
allow_tf32 False) as any caller's script has them: a reduced qwen2 `Model`
on CUDA runs every bf16 matmul with both flags off (recorded inside each
call), gives the caller's flags back, and its logits match the same model
whose bf16 matmuls are computed as f32 matmuls of the bf16 operands, the
JAX package's preferred_element_type=f32 (the port's CPU form of
layers.matmul). Needs a CUDA card with sm_90a, skips without one; imports
nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_numerics_cuda.py

Tolerance: max |difference| over max |logit| within 1e-2. Both sides sum
every product in f32 and round each matmul's output once to bf16; they
differ in summation order only, which flips the rounding of a few
elements by one bf16 ulp (2^-8 relative) and two layers carry that to
the logits."""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs.base import reduce_config
from repro_torch.models import layers, transformer

LOGIT_RTOL = 1e-2
MATMUL = torch.backends.cuda.matmul


@pytest.fixture
def cuda():
    """A CUDA device with PyTorch's default matmul flags, decided when the
    test runs (skips without a card); the process's flags back after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    saved = (MATMUL.allow_bf16_reduced_precision_reduction, MATMUL.allow_tf32)
    MATMUL.allow_bf16_reduced_precision_reduction = True
    MATMUL.allow_tf32 = False
    yield torch.device("cuda")
    MATMUL.allow_bf16_reduced_precision_reduction, MATMUL.allow_tf32 = saved


def _f32_matmul(x, w):
    return torch.matmul(x.float(), w.float()).to(layers.PARAM_DTYPE)


@pytest.mark.cuda
def test_model_accumulates_in_f32_with_default_flags(cuda, monkeypatch):
    cfg = reduce_config(repro_torch.get_config("qwen2-1.5b"), layers=2,
                        d_model=256, vocab=512)
    model = repro_torch.build_model(cfg)
    params = model.init_params(0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256))).to(cuda)
    seen = []

    def recording(x, w):
        seen.append((MATMUL.allow_bf16_reduced_precision_reduction,
                     MATMUL.allow_tf32))
        return layers.matmul(x, w)

    monkeypatch.setattr(transformer, "matmul", recording)
    monkeypatch.setattr(transformer, "matmul_rp", recording)
    got, _ = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert seen and set(seen) == {(False, False)}
    assert (MATMUL.allow_bf16_reduced_precision_reduction,
            MATMUL.allow_tf32) == (True, False)

    monkeypatch.setattr(transformer, "matmul", _f32_matmul)
    monkeypatch.setattr(transformer, "matmul_rp", _f32_matmul)
    want, _ = model.prefill(params, {"tokens": tokens})
    assert got.shape == want.shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= LOGIT_RTOL, err
