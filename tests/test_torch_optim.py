"""The port's optimizers and schedules against the JAX package's, on the
same numpy params, grads and state: AdamW and Adafactor over three
updates, clip_by_global_norm, linear_warmup_cosine and constant.

Tolerances:
  * params (bf16) within one bf16 ulp of each JAX value: both update in
    f32 and round once; a last-bit difference in the f32 result can move
    the rounding by one ulp.
  * m, v, vr, vc (f32) within 1e-6 relative: the same f32 operations in
    the same order, except that pow (the bias corrections, Adafactor's
    beta2) and the norm's sum are XLA's and PyTorch's own.
  * the global norm within 1e-6 relative (a sum over leaves in the same
    flatten order, each leaf's sum in another order).
  * schedules: equal in f32 during warm-up and for `constant`; the
    cosine part within 1e-6 relative, as XLA's and PyTorch's f32 cos
    differ in the last bits (measured: up to 5 f32 ulps of the lr)."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim.adafactor import make_optimizer as jmake
from repro.optim.adamw import clip_by_global_norm as jclip
from repro.optim.schedule import constant as jconstant
from repro.optim.schedule import linear_warmup_cosine as jcosine
from repro_torch.models import convert
from repro_torch.optim.adafactor import Adafactor, make_optimizer
from repro_torch.optim.adamw import AdamW, clip_by_global_norm, tree_map
from repro_torch.optim.schedule import SCHEDULES, constant, linear_warmup_cosine

SHAPES = {"layers": {"w": (3, 16, 24), "b": (3, 24), "ln": (3, 16)},
          "embed": (40, 16), "final_norm": (16,)}
BF16_ULP = 2.0 ** -7


def _tree(seed, scale, dtype=ml_dtypes.bfloat16):
    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(dtype)

    return build(SHAPES)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _to_torch(tree):
    return tree_map(lambda a: convert.tensor_from_numpy(a, "cpu"), tree)


def _bf16_close(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-30), \
        float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    sched = dict(peak_lr=1e-2, warmup=2, total=10)
    jopt = jmake(name, functools.partial(jcosine, **sched))
    topt = make_optimizer(name, functools.partial(linear_warmup_cosine,
                                                  **sched))
    assert isinstance(topt, {"adamw": AdamW, "adafactor": Adafactor}[name])
    params = _tree(0, 0.1)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = convert.opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
    assert ts["step"].shape == () and ts["step"].dtype == torch.int32
    for i in range(3):
        grads = _tree(10 + i, 2.0)
        jp, js, jm = jopt.update(jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = topt.update(tp, _to_torch(grads), ts)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for path, want in _flat(jax.tree.map(np.asarray, jp)).items():
        _bf16_close(_flat(tp)[path], want)
        assert _flat(tp)[path].dtype == torch.bfloat16
    jstate = _flat(jax.tree.map(np.asarray, {k: v for k, v in js.items()
                                             if k != "step"}))
    tstate = _flat({k: v for k, v in ts.items() if k != "step"})
    assert set(jstate) == set(tstate)
    for path, want in jstate.items():
        got = tstate[path].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_updates_in_place():
    """The port's update writes params, m and v in place (one copy of the
    optimizer state at full width) and returns the same tensors."""
    opt = AdamW(lr_fn=functools.partial(constant, peak_lr=1e-3))
    params = _to_torch(_tree(0, 0.1))
    state = opt.init(params)
    w, m = params["layers"]["w"], state["m"]["layers"]["w"]
    before = w.clone()
    new_p, new_s, _ = opt.update(params, _to_torch(_tree(1, 1.0)), state)
    assert new_p["layers"]["w"] is w and new_s["m"]["layers"]["w"] is m
    assert not torch.equal(w, before) and float(m.abs().max()) > 0
    with pytest.raises(ValueError):
        make_optimizer("sgd", None)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(5, 3.0)
    jg, jnorm = jclip(jax.tree.map(jnp.asarray, grads), max_norm)
    tg, tnorm = clip_by_global_norm(_to_torch(grads), max_norm)
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for path, want in _flat(jax.tree.map(np.asarray, jg)).items():
        _bf16_close(_flat(tg)[path], want)
    f32 = _tree(6, 3.0, np.float32)
    jg, jnorm = jclip(jax.tree.map(jnp.asarray, f32), 1.0)
    tg, tnorm = clip_by_global_norm(_to_torch(f32), 1.0)
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for path, want in _flat(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(_flat(tg)[path].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("peak_lr,warmup,total", [(3e-4, 2000, 2500),
                                                  (1e-3, 10, 3000),
                                                  (3e-4, 2000, 100_000)])
def test_schedules_match_jax_in_f32(peak_lr, warmup, total):
    steps = np.arange(0, 3001)
    want = np.asarray(jcosine(jnp.asarray(steps), peak_lr=peak_lr,
                              warmup=warmup, total=total))
    got = linear_warmup_cosine(torch.as_tensor(steps), peak_lr=peak_lr,
                               warmup=warmup, total=total).numpy()
    assert got.dtype == want.dtype == np.float32
    warm = steps < warmup
    np.testing.assert_array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got[~warm], want[~warm], rtol=1e-6, atol=0)
    c = constant(torch.tensor(7), peak_lr=peak_lr)
    assert c.dtype == torch.float32 and c.shape == ()
    assert float(c) == float(jconstant(7, peak_lr=peak_lr))
    assert set(SCHEDULES) == {"cosine", "constant"}
