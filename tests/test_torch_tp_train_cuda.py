"""Tensor-parallel training on the card: a 2-rank gloo world on cuda:0
over a {"model": 2} mesh (tests/_torch_tp_worker.run_world, the cases of
tests/_torch_tp_train_worker.py; NCCL refuses two ranks on one GPU).
A reduced qwen2 with flash on (S = 256, 12 heads and 2 kv heads of 32:
flash_fwd and both backward kernels run on a rank's 6 heads and 1 kv
head) held to the same steps on one device of the card, with
tests/test_torch_tp_train.py's tolerances; and the hybrid, ssm, encdec
and vlm families at tests/test_torch_tp_train.py's reduced widths
(FAMILIES; internvl2 with flash on at 8 vis + 248 text positions, so
the kernels run on a rank's 6 heads and 1 kv head), their losses and
step 0's grads held to one device (step 1's grads move with AdamW's
first +-lr update, as there). Needs a CUDA card and skips without one;
the file imports nothing of jax."""

import numpy as np
import pytest
import torch

import _torch_dp_worker as D
import _torch_tp_worker as W

pytestmark = pytest.mark.cuda

LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(seed, b=4, s=256, vocab=512):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :7] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


DENSE = dict(arch="qwen2-1.5b", reduce=dict(layers=2, d_model=256,
                                             vocab=512),
             replace=dict(use_flash_attention=True, n_heads=12,
                          n_kv_heads=2, head_dim=32),
             seed=0, batches=[_batch(0), _batch(1)])


def test_tp_step_on_the_card(cuda, tmp_path):
    ref = D.dp_step(None, dict(DENSE, device="cuda"))   # builds the kernels
    world = W.run_world(tmp_path, 2, [("tp_step", DENSE)], device="cuda",
                        module="_torch_tp_train_worker")
    got = world[0]["tp_step"]
    np.testing.assert_allclose([s["metrics"]["loss"] for s in got["steps"]],
                               [s["metrics"]["loss"] for s in ref["steps"]],
                               atol=LOSS_ATOL, rtol=0)
    for g, r in zip(got["steps"], ref["steps"]):
        for path, w in D._flat(r["grads"]).items():
            err = float(np.max(np.abs(D._flat(g["grads"])[path] - w)))
            assert err <= GRAD_RTOL * float(np.max(np.abs(w))), (path, err)
    assert got["local_shapes"]["layers/attn/wq"][-1] == 6 * 32
    assert got["local_shapes"]["layers/attn/wk"][-1] == 32
    for s0, s1 in zip(got["steps"], world[1]["tp_step"]["steps"]):
        assert s0["metrics"] == s1["metrics"]
        for path, dim in got["model_dims"].items():
            if dim is None:
                assert s0["leaves"][path] == s1["leaves"][path], path


def _family_batches(name, s, vocab, d):
    out = []
    for seed in (0, 1):
        b = _batch(seed, s=s, vocab=vocab)
        rng = np.random.default_rng(10 + seed)
        if name == "encdec":
            b["frames"] = (0.02 * rng.standard_normal((4, 64, d))).astype(
                np.float32)
        if name == "vlm":
            b["vis"] = (0.02 * rng.standard_normal((4, 8, d))).astype(
                np.float32)
        out.append(b)
    return out


# tests/test_torch_tp_train.py's FAMILIES, on the port's init
FAMILIES = {
    "hybrid": dict(arch="hymba-1.5b", seq=128,
                   reduce=dict(layers=2, d_model=160, vocab=127)),
    "ssm": dict(arch="rwkv6-7b", seq=64,
                reduce=dict(layers=2, d_model=128, vocab=128)),
    "encdec": dict(arch="whisper-small", seq=32,
                   reduce=dict(layers=2, d_model=128, vocab=127)),
    "vlm": dict(arch="internvl2-26b", seq=248,
                reduce=dict(layers=2, d_model=384, vocab=127),
                replace=dict(use_flash_attention=True)),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_tp_step_on_the_card(cuda, tmp_path, name):
    f = FAMILIES[name]
    payload = dict(arch=f["arch"], reduce=f["reduce"],
                   replace=f.get("replace", {}), seed=0,
                   batches=_family_batches(name, f["seq"],
                                           f["reduce"]["vocab"],
                                           f["reduce"]["d_model"]))
    ref = D.dp_step(None, dict(payload, device="cuda"))
    world = W.run_world(tmp_path, 2, [("tp_step", payload)], device="cuda",
                        module="_torch_tp_train_worker")
    got = world[0]["tp_step"]
    np.testing.assert_allclose([s["metrics"]["loss"] for s in got["steps"]],
                               [s["metrics"]["loss"] for s in ref["steps"]],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(
        [s["metrics"]["grad_norm"] for s in got["steps"]],
        [s["metrics"]["grad_norm"] for s in ref["steps"]], rtol=GRAD_RTOL)
    g, r = got["steps"][0], ref["steps"][0]
    for path, w in D._flat(r["grads"]).items():
        err = float(np.max(np.abs(D._flat(g["grads"])[path] - w)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(w))), (path, err)
    assert any(d is not None for d in got["model_dims"].values())
    for s0, s1 in zip(got["steps"], world[1]["tp_step"]["steps"]):
        assert s0["metrics"] == s1["metrics"]
        for path, dim in got["model_dims"].items():
            if dim is None:
                assert s0["leaves"][path] == s1["leaves"][path], path
