"""The port's training path against the JAX package's, below the Trainer
(the JAX Trainer needs a mesh, which fails on this jax; ROADMAP queue 3):
`Model.loss_fn` value and grads, and two train steps against the JAX
composition of `jax.value_and_grad(loss_fn)` and
`make_optimizer("adamw", partial(linear_warmup_cosine, ...)).update`, on
the same weights (carried across with convert.params_from_numpy) and the
same numpy tokens, qwen2-1.5b reduced to 2 layers, d_model 128, vocab
256, Hd 32, B 2. With `use_flash_attention` on, the JAX side runs its
Pallas forward and both backward kernels in interpret mode and the port
the kernels' plain versions. Then the port alone: microbatches and
bf16 grads, its Trainer on the CPU (the loss check of
tests/test_system.py and an exact restart), the heartbeat, the refusal of
a model axis (tensor-parallel training).

Tolerances: the loss within LOSS_ATOL = 5e-3 absolute and every grad leaf
within GRAD_RTOL = 3e-2 of that leaf's max |JAX grad|. Both sides round
activations to bf16 after every product, norm and residual and sum in
another order, so an activation can land one bf16 ulp apart and that
propagates through two layers and back; the bf16 grads round once more.
The JAX references are computed once per module (each value_and_grad
takes seconds in interpret mode)."""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro.optim.adafactor import make_optimizer as jmake_optimizer
from repro.optim.schedule import linear_warmup_cosine as jschedule
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.dist.fault import HeartbeatFile
from repro_torch.kernels.flash import flash_cuda
from repro_torch.models import convert
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.step import build_train_step
from repro_torch.train.trainer import TrainLoopConfig, Trainer

LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
KW = dict(layers=2, d_model=128, vocab=256)
B = 2
STEP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=10)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("qwen2-1.5b"), **KW)
    tcfg = reduce_config(get_config("qwen2-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


def _fresh(tree):
    """A copy of the port's params that a step may update in place."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _batch(s, seed=0, masked=True):
    """tokens/labels (B, S) int32 from a seed; with `masked`, a few labels
    are -1 (left out of the loss)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, KW["vocab"], (B, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[0, :7] = -1
        labels[1, s // 2:s // 2 + 5] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_refs(weights):
    """(flash, S) -> (loss, metrics, grads) of the JAX loss_fn, numpy."""
    jcfg, _, jp, _ = weights
    cache = {}

    def get(flash, s):
        if (flash, s) not in cache:
            m = jbuild(dataclasses.replace(jcfg, use_flash_attention=flash))
            batch = {k: jnp.asarray(v) for k, v in _batch(s).items()}
            (loss, met), g = jax.value_and_grad(m.loss_fn, has_aux=True)(
                jp, batch)
            cache[(flash, s)] = (float(loss),
                                 {k: float(v) for k, v in met.items()},
                                 jax.tree.map(np.asarray, g))
        return cache[(flash, s)]

    return get


def _grads_close(tgrads, jgrads):
    for path, j in _flat(jgrads).items():
        t = _flat(tgrads)[path]
        j = np.asarray(j, np.float32)
        err = float(np.max(np.abs(t.float().numpy() - j)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(j))), (path, err)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("flash,s,remat", [
    (False, 256, "none"), (False, 256, "full"),
    (True, 256, "none"), (True, 256, "dots"),
    (True, 512, "none"), (True, 512, "dots"), (True, 512, "full")])
def test_loss_fn_value_and_grads_match_jax(weights, jax_refs, flash, s, remat):
    _, tcfg, _, tp = weights
    jloss, jmet, jgrads = jax_refs(flash, s)
    cfg = dataclasses.replace(tcfg, use_flash_attention=flash, remat=remat)
    params = _fresh(tp)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    before = flash_cuda.flash_fwd.launches
    total, met = build_model(cfg).loss_fn(params, _tbatch(_batch(s)))
    grads = torch.autograd.grad(total, leaves)
    assert flash_cuda.flash_fwd.launches == before      # CPU: plain versions
    assert abs(float(total.detach()) - jloss) <= LOSS_ATOL
    assert abs(float(met["loss"].detach()) - jmet["loss"]) <= LOSS_ATOL
    assert float(met["ntokens"]) == jmet["ntokens"] == B * s - 12
    assert float(met["aux"]) == jmet["aux"] == 0.0
    _grads_close(tree_unflatten(params, grads), jgrads)


def test_flash_route_carries_the_backward(weights):
    """With flash on at S = 256 the model's attention goes through
    FlashAttention: its backward (the plain dq/dkv on the CPU) runs once a
    layer for the gradient, and the grads equal those of the chunked path
    within the parity bound."""
    _, tcfg, _, tp = weights
    calls = []
    real = flash_cuda.flash_bwd_dq
    flash_cuda.flash_bwd_dq = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        out = {}
        for flash in (True, False):
            params = _fresh(tp)
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            cfg = dataclasses.replace(tcfg, use_flash_attention=flash)
            total, _ = build_model(cfg).loss_fn(params, _tbatch(_batch(256)))
            out[flash] = torch.autograd.grad(total, leaves)
    finally:
        flash_cuda.flash_bwd_dq = real
    assert len(calls) == tcfg.n_layers
    for a, b in zip(out[True], out[False]):
        assert float((a.float() - b.float()).abs().max()) <= \
            GRAD_RTOL * float(b.float().abs().max())


def test_two_train_steps_match_jax_composition(weights):
    jcfg, tcfg, jp, tp = weights
    jcfg = dataclasses.replace(jcfg, use_flash_attention=True, remat="full")
    tcfg = dataclasses.replace(tcfg, use_flash_attention=True, remat="full")
    jm = jbuild(jcfg)
    opt = jmake_optimizer("adamw", functools.partial(
        jschedule, peak_lr=STEP_KW["peak_lr"], warmup=STEP_KW["warmup"],
        total=STEP_KW["total_steps"]))
    grad_fn = jax.value_and_grad(jm.loss_fn, has_aux=True)
    step_fn, topt = build_train_step(build_model(tcfg), **STEP_KW)
    jparams, jstate = jp, opt.init(jp)
    params = _fresh(tp)
    state = topt.init(params)
    for i in range(2):
        batch = _batch(256, seed=10 + i, masked=False)
        (jloss, _), jg = grad_fn(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
        jparams, jstate, jmet = opt.update(jparams, jg, jstate)
        params, state, met = step_fn(params, state, _tbatch(batch))
        assert abs(float(met["loss"].detach()) - float(jloss)) <= LOSS_ATOL
        assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= \
            GRAD_RTOL * float(jmet["grad_norm"])
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 2
    assert state["step"].dtype == torch.int32


def test_microbatches_and_bf16_grads(weights):
    """microbatches=2 against 1 on the same batch (the mean of the two
    halves' losses; f32-accumulated grads); grad_compress="bf16" hands the
    optimizer bf16 grads, and the step is otherwise the same."""
    _, tcfg, _, tp = weights
    model = build_model(tcfg)
    batch = _tbatch(_batch(64, seed=3, masked=False))
    seen = {}
    out = {}
    for mb, gc in ((1, "none"), (2, "none"), (2, "bf16")):
        step_fn, opt = build_train_step(model, microbatches=mb,
                                        grad_compress=gc, **STEP_KW)
        real = opt.update

        def spy(params, grads, state, real=real, key=(mb, gc)):
            seen[key] = {g.dtype for g in tree_leaves(grads)}
            return real(params, grads, state)

        object.__setattr__(opt, "update", spy)
        params = _fresh(tp)
        _, _, met = step_fn(params, opt.init(params), batch)
        out[(mb, gc)] = met
    assert seen == {(1, "none"): {torch.bfloat16}, (2, "none"): {torch.float32},
                    (2, "bf16"): {torch.bfloat16}}
    one, two, comp = out[(1, "none")], out[(2, "none")], out[(2, "bf16")]
    assert float(two["loss"]) == pytest.approx(float(one["loss"]), abs=1e-4)
    # f32-averaged grads vs bf16 grads: one bf16 rounding (2^-9) apart
    assert float(two["grad_norm"]) == pytest.approx(float(one["grad_norm"]),
                                                    rel=1e-2)
    assert float(comp["grad_norm"]) == pytest.approx(float(two["grad_norm"]),
                                                     rel=1e-2)
    with pytest.raises(ValueError):
        build_train_step(model, grad_compress="int8")


def _tiny_loop(tmp_path, total_steps, ckpt_every=4):
    cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=64,
                        vocab=128)
    loop = TrainLoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                           log_every=100, ckpt_dir=str(tmp_path / "ckpt"),
                           seq_len=32, global_batch=4, peak_lr=1e-3)
    return cfg, Trainer(cfg, loop, device="cpu")


def test_trainer_runs_and_loss_decreases(tmp_path):
    cfg, tr = _tiny_loop(tmp_path, total_steps=12, ckpt_every=50)
    out = tr.run(verbose=False)
    assert len(out["losses"]) == 12
    assert np.isfinite(out["losses"]).all()
    # synthetic uniform tokens: loss should approach log(vocab) from init
    assert out["losses"][-1] < out["losses"][0] + 0.5
    assert sorted(out["metrics"]) == ["aux", "grad_norm", "loss", "lr",
                                      "ntokens", "total_loss"]


def test_trainer_restart_idempotent(tmp_path):
    """Run 8 steps; separately run 4 (checkpoint at 4), 'crash', restart
    to 8. On the CPU the resumed losses equal the uninterrupted run's
    exactly: step-keyed data, a bit-exact checkpoint, deterministic ops."""
    _, tr_full = _tiny_loop(tmp_path / "a", total_steps=8, ckpt_every=100)
    full = tr_full.run(verbose=False)["losses"]
    _, tr1 = _tiny_loop(tmp_path / "b", total_steps=4, ckpt_every=4)
    tr1.run(verbose=False)
    _, tr2 = _tiny_loop(tmp_path / "b", total_steps=8, ckpt_every=4)
    out = tr2.run(verbose=False)
    assert out["start_step"] == 4
    assert out["losses"] == full[4:]
    for a, b in zip(tree_leaves(tr2.state), tree_leaves(tr_full.state)):
        assert torch.equal(a, b)


def test_heartbeat_is_written(tmp_path):
    _, tr = _tiny_loop(tmp_path, total_steps=3, ckpt_every=100)
    tr.run(verbose=False)
    beat = HeartbeatFile(str(tmp_path / "ckpt")).read()
    assert beat["step"] == 2
    assert not HeartbeatFile(str(tmp_path / "ckpt")).stale(timeout_s=300)
    with open(tmp_path / "ckpt" / "LATEST") as fh:
        assert fh.read() == "step_00000003"
    manifest = json.load(open(tmp_path / "ckpt" / "step_00000003" /
                              "manifest.json"))
    assert manifest["leaves"]["opt/step"]["dtype"] == "int32"
    assert os.path.exists(tmp_path / "ckpt" / "HEARTBEAT")


def test_trainer_mesh_and_card_default(tmp_path):
    cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=64,
                        vocab=128)
    loop = TrainLoopConfig(ckpt_dir=str(tmp_path / "ckpt"))
    # data-parallel meshes train (tests/test_torch_dist_train.py), model
    # axes too for every family (tests/test_torch_tp_train.py), and FSDP
    # beside a model axis: the plan splits a dim over both, hymba's packed
    # in_proj among them, and the Trainer's step reads it as the model
    # axis's dim and the data axes' (no process group needed to plan)
    from repro_torch.dist import sharding
    from repro_torch.train import step as step_lib
    hybrid = reduce_config(get_config("hymba-1.5b"), layers=2, d_model=64,
                           vocab=128)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    model = build_model(hybrid)
    plan = step_lib.make_plan(hybrid, mesh, kind="train", fsdp=True)
    specs = sharding.params_shardings(plan, model.param_axes,
                                      model.abstract_params(),
                                      model.param_parts)
    in_proj = specs["layers"]["mamba"]["in_proj"]
    assert tuple(in_proj) == (None, None, ("model", "data"))
    assert sharding.spec_parts(in_proj) == 2
    assert sharding.model_dims(plan, specs)["layers"]["mamba"][
        "in_proj"] == sharding.data_dims(plan, specs)["layers"]["mamba"][
        "in_proj"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # the card is the default
            Trainer(cfg, loop)
