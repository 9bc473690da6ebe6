"""Data-parallel training on the card: a 2-rank gloo world on cuda:0
(tests/_torch_tp_worker.run_world over a {"data": 2} mesh, the cases of
tests/_torch_dp_worker.py; NCCL refuses two ranks on one GPU, and the
port stages gloo's collectives through host memory). Held to the same
calls on one device of the card, with test_torch_dist_train.py's
tolerances: a reduced qwen2 with flash on (S = 256, so the kernels run on
every rank) trained by DP and by FSDP, moe_ffn_ep against its
one-process emulation, allreduce_int8 against the arithmetic on the
host, pipelined_apply and its gradient against the dense loop. Every
test here needs a
CUDA card and skips without one; the file imports nothing of jax."""

import numpy as np
import pytest
import torch

import _torch_dp_worker as D
import _torch_tp_worker as W

pytestmark = pytest.mark.cuda

LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
OUT_ULPS = 2 * 2.0 ** -8
PIPE_ATOL = 1e-4


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
             replace=dict(use_flash_attention=True), seed=0,
             batches=[_batch(0), _batch(1)])


def _moe():
    """x (T, D), the layer's params (bf16) and a cotangent, from a seed."""
    rng = np.random.default_rng(5)
    e, d, f, t = 8, 256, 128, 512

    def w(*shape, scale=0.2):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).bfloat16()

    p = {"router": w(d, e), "wi": w(e, d, f), "wg": w(e, d, f),
         "wo": w(e, f, d), "shared_wi": w(d, 2 * f), "shared_wg": w(d, 2 * f),
         "shared_wo": w(2 * f, d)}
    return w(t, d, scale=1.0), p, w(t, d, scale=1.0).float()


def _flat(tree):
    return D._flat(tree)


def _grads_close(got, want):
    want, got = _flat(want), _flat(got)
    for path, w in want.items():
        err = float(np.max(np.abs(got[path] - w)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(w))), (path, err)


def test_dp_and_fsdp_on_the_card(cuda, tmp_path):
    ref = D.dp_step(None, dict(DENSE, device="cuda"))   # builds the kernels
    world = W.run_world(tmp_path, 2, [("dp_step:dp", DENSE),
                                      ("dp_step:fsdp", dict(DENSE,
                                                            fsdp=True))],
                        device="cuda", shape={"data": 2},
                        module="_torch_dp_worker")
    for name in ("dp_step:dp", "dp_step:fsdp"):
        got = world[0][name]
        print(name, [s["metrics"]["loss"] for s in got["steps"]],
              [s["metrics"]["loss"] for s in ref["steps"]])
        np.testing.assert_allclose(
            [s["metrics"]["loss"] for s in got["steps"]],
            [s["metrics"]["loss"] for s in ref["steps"]], atol=LOSS_ATOL,
            rtol=0)
        for g, r in zip(got["steps"], ref["steps"]):
            _grads_close(g["grads"], r["grads"])
        assert [s["digest"] for s in got["steps"]] == \
            [s["digest"] for s in world[1][name]["steps"]]


def test_moe_ffn_ep_on_the_card(cuda, tmp_path):
    from repro_torch.models import moe
    x, p, cot = _moe()
    # f32 arrays of bf16 values, cast back to bf16 on the ranks (exact)
    payload = {"x": x.float().numpy(), "cot": cot.numpy(),
               "params": {k: v.float().numpy() for k, v in p.items()},
               "n_experts": 8, "k": 2, "coef": 0.1, "as_bf16": True}
    world = W.run_world(tmp_path, 2, [("moe_ep", payload)],
                        device="cuda", shape={"data": 2},
                        module="_torch_dp_worker")
    got = np.concatenate([world[r]["moe_ep"]["out"] for r in (0, 1)])
    for dev in (cuda, torch.device("cpu")):
        with torch.no_grad():
            emu, aux = moe.moe_ffn_ep_emulated(
                x.to(dev), {k: v.to(dev) for k, v in p.items()},
                n_experts=8, k=2, n_shards=2)
        want = emu.float().cpu().numpy()
        err = np.abs(got - want).max()
        print(dev, "max |diff|", err, "bit-equal", bool((got == want).all()))
        assert err <= OUT_ULPS * np.abs(want).max()
        assert abs(world[0]["moe_ep"]["aux"] - float(aux)) <= 1e-5


def test_int8_and_pipeline_on_the_card(cuda, tmp_path):
    rng = np.random.default_rng(9)
    g = rng.standard_normal((2, 64, 256)).astype(np.float32)
    pipe = {"w": (rng.standard_normal((8, 256, 256)) / 16).astype(np.float32),
            "x": rng.standard_normal((4, 8, 256)).astype(np.float32),
            "cot": rng.standard_normal((4, 8, 256)).astype(np.float32)}
    world = W.run_world(tmp_path, 2, [("int8", {"g": g}),
                                      ("pipeline", pipe)],
                        device="cuda", shape={"data": 2},
                        module="_torch_dp_worker")
    # the same arithmetic on the host, two ranks at once
    gt = torch.from_numpy(g)
    scale = torch.clamp_min(gt.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(gt / scale), -127, 127).to(torch.int32)
    mean = q.sum(0).float() * scale / 2
    for r in (0, 1):
        np.testing.assert_array_equal(world[r]["int8"]["out"], mean.numpy())
        res = (gt[r] - q[r].float() * scale).numpy()
        np.testing.assert_array_equal(world[r]["int8"]["res"], res)
    # the outputs and the gradient of sum(out * cot) (a rank's stage, the
    # stream) against the dense loop on the host
    w = torch.from_numpy(pipe["w"]).requires_grad_(True)
    x = torch.from_numpy(pipe["x"]).requires_grad_(True)
    dense = x
    for i in range(8):
        dense = torch.tanh(dense @ w[i])
    gw, gx = torch.autograd.grad((dense * torch.from_numpy(pipe["cot"]))
                                 .sum(), [w, x])
    for r in (0, 1):
        got = world[r]["pipeline"]
        assert np.abs(got["out"] - dense.detach().numpy()).max() < PIPE_ATOL
        assert np.abs(got["gw"] - gw[4 * r:4 * r + 4].numpy()).max() \
            < PIPE_ATOL
        assert np.abs(got["gx"] - gx.numpy()).max() < PIPE_ATOL
