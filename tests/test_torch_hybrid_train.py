"""The port's hybrid training (hymba's train stack and loss_fn) against the
JAX package's, on the same weights (the JAX params carried across with
convert.params_from_numpy) and the same numpy tokens, at the reduced
hymba-1.5b (2 layers, d_model 64, vocab 128, window 64, N = 16) and
S = 128, so the window mask bites in the forward and in the backward.

As in tests/test_torch_hybrid.py, four mamba leaves are scaled (ACTIVE)
so the scan moves the loss and its gradients; at the 0.02 init it would
not. The JAX side is compiled with xla_allow_excess_precision off, as in
tests/test_torch_moe_model.py.

ssm_impl "chunked" and "scan": the loss within LOSS_ATOL = 1e-3 and every
gradient leaf within GRAD_RTOL = 3e-2 of its max |JAX grad|, as
tests/test_torch_train.py (bf16 activations and grads, sums in another
order). remat "none" and "full" give bit-equal grads. "pallas": the
kernel has no backward; the JAX package's jax.grad raises ValueError (it
cannot linearize the Pallas call), and the port's backward raises
NotImplementedError, on the CPU too (the plain version stands in the
kernel's place there and would otherwise differentiate); its forward
loss equals JAX's within LOSS_ATOL. Then the Trainer: a few steps with
"chunked", and "pallas" failing at its first backward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.kernels.ssm import ssm_cuda
from repro_torch.models import convert
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.train.trainer import TrainLoopConfig, Trainer

LOSS_ATOL = 1e-3
GRAD_RTOL = 3e-2
KW = dict(layers=2, d_model=64, vocab=128)
ACTIVE = {"in_proj": 5.0, "conv_w": 25.0, "x_proj": 10.0, "dt_proj": 10.0}
S = 128
NO_BACKWARD = "selective-scan kernel .* has no backward"


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("hymba-1.5b"), **KW)
    tcfg = reduce_config(get_config("hymba-1.5b"), **KW)
    assert jcfg.attn_window == tcfg.attn_window == 64
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    mp = dict(jp["layers"]["mamba"])
    for k, f in ACTIVE.items():
        mp[k] = (mp[k].astype(jnp.float32) * f).astype(jnp.bfloat16)
    jp = {**jp, "layers": {**jp["layers"], "mamba": mp}}
    return jcfg, tcfg, jp


@pytest.fixture(scope="module")
def batch():
    toks = np.random.default_rng(0).integers(0, 128, (2, S + 1)).astype(
        np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][1, :9] = -1
    return b


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _port_loss_and_grads(weights, batch, impl, remat="none"):
    jcfg, tcfg, jp = weights
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    cfg = dataclasses.replace(tcfg, ssm_impl=impl, remat=remat)
    total, met = build_model(cfg).loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return total, met, leaves, params


@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_loss_and_grads_match_jax(weights, batch, impl):
    jcfg, _, jp = weights
    jm = jbuild(dataclasses.replace(jcfg, ssm_impl=impl))
    (jtotal, jmet), jg = _strict(jax.value_and_grad(jm.loss_fn, has_aux=True),
                                 jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    total, met, leaves, params = _port_loss_and_grads(weights, batch, impl)
    grads = _flat(tree_unflatten(params, torch.autograd.grad(total, leaves)))
    assert abs(float(total.detach()) - float(jtotal)) <= LOSS_ATOL
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert float(met["ntokens"]) == float(jmet["ntokens"]) == 2 * S - 9
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for path, j in jflat.items():
        j = np.asarray(j, np.float32)
        t = grads[path].float().numpy()
        err = float(np.max(np.abs(t - j)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(j))), (path, err)
    # the scan reaches the loss: its gradients are not negligible
    assert float(np.abs(jflat["layers/mamba/a_log"]).max()) > 1e-4


def test_remat_full_gives_the_same_grads(weights, batch):
    """Each layer under torch.utils.checkpoint recomputes its forward in
    the backward: the grads equal remat "none"'s bit for bit."""
    runs = []
    for remat in ("none", "full"):
        total, _, leaves, _ = _port_loss_and_grads(weights, batch, "chunked",
                                                   remat)
        runs.append((total.detach(), torch.autograd.grad(total, leaves)))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_pallas_forward_matches_and_backward_raises(weights, batch,
                                                   monkeypatch):
    """The forward through the scan kernel's wrapper (its plain version on
    the CPU, one call a layer) gives JAX's loss; the backward raises, as
    JAX's grad does."""
    jcfg, _, jp = weights
    jm = jbuild(dataclasses.replace(jcfg, ssm_impl="pallas"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtotal, _ = jm.loss_fn(jp, jbatch)
    with pytest.raises(ValueError):
        jax.grad(lambda p: jm.loss_fn(p, jbatch)[0])(jp)
    calls = []
    real = ssm_cuda.ssm_scan

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(ssm_cuda, "ssm_scan", spy)
    total, _, leaves, _ = _port_loss_and_grads(weights, batch, "pallas")
    assert calls == [(2, S, 128)] * 2
    assert abs(float(total.detach()) - float(jtotal)) <= LOSS_ATOL
    with pytest.raises(NotImplementedError, match=NO_BACKWARD):
        torch.autograd.grad(total, leaves)


def _loop(tmp_path, steps):
    return TrainLoopConfig(total_steps=steps, ckpt_every=100, log_every=100,
                           ckpt_dir=str(tmp_path / "ckpt"), seq_len=128,
                           global_batch=2, peak_lr=1e-3)


def test_trainer_steps_and_the_pallas_refusal(tmp_path):
    """Three Trainer steps with ssm_impl "chunked" and remat "full" give
    finite losses; with "pallas" the first step's backward raises."""
    cfg = dataclasses.replace(
        reduce_config(get_config("hymba-1.5b"), **KW), remat="full")
    out = Trainer(cfg, _loop(tmp_path / "a", 3), device="cpu").run(
        verbose=False)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    tr = Trainer(dataclasses.replace(cfg, ssm_impl="pallas"),
                 _loop(tmp_path / "b", 1), device="cpu")
    with pytest.raises(NotImplementedError, match=NO_BACKWARD):
        tr.run(verbose=False)
