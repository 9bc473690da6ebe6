"""Data-parallel training in the port (ROADMAP item 9.2) against the JAX
package: every rank case runs in one 2-rank gloo world on the CPU
(tests/_torch_tp_worker.run_world over a {"data": 2} mesh, the cases in
tests/_torch_dp_worker.py), and the JAX references in one subprocess
with 2 forced host devices (as tests/test_dist.py's sharded tests).

  (a) the DP step on a reduced qwen2 (2 layers, d 64, vocab 128, B 4,
      S 32, 2 steps) against the JAX package's own sharded DP step
      (make_plan + build_train_step on a ("data", 2) mesh): losses within
      LOSS_ATOL, step 0's grads within GRAD_RTOL of each leaf's max |JAX
      grad| (test_torch_train.py's tolerances, for the same reason: bf16
      activations rounded in another order); both ranks' params
      bit-equal after every step;
  (b) DP against the port's one-device step with microbatches 2, bf16
      grads and Adafactor; (c) FSDP against DP with AdamW and Adafactor
      (the JAX package's FSDP, microbatched and moe DP steps fail on this
      jax, ROADMAP queue 3, so the port's DP and one-device steps are
      the references there): the same tolerances;
  (d) make_plan's fields against the reference's for every config and
      kind on stand-in meshes;
  (e) ef_int8_compress bit-equal to JAX's, and allreduce_int8 over the 2
      ranks against JAX's over 2 devices: the mean bit-equal, the new
      residual within one f32 ulp of max |g| (jit fuses JAX's
      gf - q scale into an FMA);
  (f) moe_ffn_ep over the 2 ranks against JAX's moe_ffn_ep on 2 devices:
      the output within OUT_ULPS bf16 ulps of max |out|, aux within
      AUX_RTOL, the grads of x and of every weight within GRAD_RTOL of
      each one's max; and the output, aux and the grads of x and of the
      experts bit-equal to the port's one-process emulation
      (moe_ffn_ep_emulated);
  (g) the global capacity route under DP (experts whole, and split by
      EP below the EP threshold) against the one-device moe_ffn on the
      global batch: output and aux bit-equal, grads within GRAD_RTOL;
  (h) pipelined_apply over the 2 ranks against JAX's and the dense scan
      (1e-4, the reference test's bound), its gradient (a stage's params,
      the stream) against autograd through the dense loop and JAX's
      jax.grad through its own; bubble_fraction equal;
  (i) the elastic checkpoint: 1 -> 2 (a one-device checkpoint restored
      into FSDP blocks) and 2 -> 1 (an FSDP world's checkpoint restored
      on one device), bit-equal;
  (j) a 2-rank FSDP Trainer stopped after step 2 and resumed gives the
      4 losses of a straight run, bit for bit, and equal on both ranks.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as D
import _torch_tp_worker as W
from repro.configs.base import ARCH_IDS as JARCH_IDS
from repro.configs.base import get_config as jget
from repro.optim import compress as jcompress
from repro.train import step as jstep
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ARCH_IDS, get_config, reduce_config
from repro_torch.dist import pipeline, sharding
from repro_torch.models import moe
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.optim import compress
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import TrainLoopConfig, Trainer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
OUT_ULPS = 2 * 2.0 ** -8
AUX_RTOL = 1e-5
PIPE_ATOL = 1e-4
DENSE = dict(arch="qwen2-1.5b", reduce=dict(layers=2, d_model=64,
                                             vocab=128), seed=0)
MOE = dict(n_experts=8, k=2, d=64, f=32, t=128, coef=0.1)


def _batch(seed, b=4, s=32, vocab=128):
    """tokens/labels (B, S) int32; a few labels -1 (out of the loss)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :7] = -1
    labels[3, 10:15] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


BATCHES = [_batch(0), _batch(1)]


def _bf16(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16))


def _moe_inputs():
    rng = np.random.default_rng(5)
    e, d, f, t = MOE["n_experts"], MOE["d"], MOE["f"], MOE["t"]
    p = {"router": _bf16(0.2 * rng.standard_normal((d, e))),
         "wi": _bf16(0.2 * rng.standard_normal((e, d, f))),
         "wg": _bf16(0.2 * rng.standard_normal((e, d, f))),
         "wo": _bf16(0.2 * rng.standard_normal((e, f, d))),
         "shared_wi": _bf16(0.2 * rng.standard_normal((d, 2 * f))),
         "shared_wg": _bf16(0.2 * rng.standard_normal((d, 2 * f))),
         "shared_wo": _bf16(0.2 * rng.standard_normal((2 * f, d)))}
    return {"x": _bf16(rng.standard_normal((t, d))),
            "cot": rng.standard_normal((t, d)).astype(np.float32),
            "params": p, "n_experts": e, "k": MOE["k"], "coef": MOE["coef"]}


def _pipe_inputs():
    rng = np.random.default_rng(7)
    return {"w": (rng.standard_normal((8, 16, 16)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((4, 2, 16)).astype(np.float32),
            "cot": rng.standard_normal((4, 2, 16)).astype(np.float32)}


def _int8_inputs():
    rng = np.random.default_rng(9)
    return {"g": rng.standard_normal((2, 8, 64)).astype(np.float32)}


JAX_SCRIPT = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config, reduce_config
from repro.dist.pipeline import pipelined_apply
from repro.models import moe
from repro.models.registry import build_model
from repro.optim.compress import allreduce_int8, init_residual
from repro.train import step as step_lib

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
mesh = jax.make_mesh((2,), ("data",))
rows = NamedSharding(mesh, P("data"))

# (a) the sharded DP step
cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=64, vocab=128)
model = build_model(cfg)
plan = step_lib.make_plan(cfg, mesh, kind="train")
ctx = step_lib.make_dist_ctx(plan)
bundle, opt = step_lib.build_train_step(model, plan, peak_lr=1e-3, warmup=1,
                                        total_steps=10)
with jax.set_mesh(mesh):
    params = jax.jit(model.init_params, out_shardings=bundle.in_shardings[0])(
        jax.random.PRNGKey(0))
    out["params"] = jax.tree.map(np.array, params)
    opt_state = jax.jit(opt.init, out_shardings=bundle.in_shardings[1])(params)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in inp["batches"]]
    vg = jax.jit(jax.value_and_grad(lambda p, b: model.loss_fn(p, b, ctx),
                                    has_aux=True))
    (_, met), g = vg(params, batches[0])
    out["grads0"] = jax.tree.map(np.array, g)
    step = jax.jit(bundle.fn, in_shardings=bundle.in_shardings[:2] + (None,),
                   out_shardings=bundle.out_shardings,
                   donate_argnums=bundle.donate_argnums)
    out["metrics"] = []
    for b in batches:
        params, opt_state, m = step(params, opt_state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})

# (e) allreduce_int8: rank r's grads are rows [8 r, 8 r + 8)
g = {"w": jnp.asarray(inp["int8"]["g"].reshape(16, 64))}
with jax.set_mesh(mesh):
    gd = jax.device_put(g, {"w": rows})
    o, r = jax.jit(lambda g, r: allreduce_int8(g, r, mesh, ("data",)))(
        gd, init_residual(g))
out["int8"] = {"out": np.array(o["w"]), "res": np.array(r["w"])}

# (f) moe_ffn_ep on 2 devices, forward and grads
mi = inp["moe"]
x = jnp.asarray(mi["x"])
p = {k: jnp.asarray(v) for k, v in mi["params"].items()}
cot = jnp.asarray(mi["cot"])
shard = {k: (rows if k in ("wi", "wg", "wo") else NamedSharding(mesh, P()))
         for k in p}
def f(x, p):
    o, aux = moe.moe_ffn_ep(x, p, n_experts=mi["n_experts"], k=mi["k"],
                            mesh=mesh, dp_axes=("data",))
    return (o.astype(jnp.float32) * cot).sum() + mi["coef"] * aux, (o, aux)
with jax.set_mesh(mesh):
    xd, pd = jax.device_put(x, rows), jax.device_put(p, shard)
    (_, (o, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(xd, pd)
out["moe"] = {"out": np.array(o.astype(jnp.float32)), "aux": float(aux),
              "gx": np.array(gx.astype(jnp.float32)),
              "gp": {k: np.array(v.astype(jnp.float32)) for k, v in gp.items()}}

# (h) the GPipe schedule over the 2 devices, and jax.grad through it of
# sum(out * cot) with respect to the stack and the stream
pi = inp["pipe"]
def pipe(w, x):
    return pipelined_apply(lambda q, h: jnp.tanh(h @ q), w, x, mesh=mesh,
                           pp_axis="data")
with jax.set_mesh(mesh):
    w, x = jnp.asarray(pi["w"]), jnp.asarray(pi["x"])
    o = jax.jit(pipe)(w, x)
    gw, gx = jax.jit(jax.grad(lambda w, x: (pipe(w, x) * pi["cot"]).sum(),
                              argnums=(0, 1)))(w, x)
out["pipe"] = np.array(o)
out["pipe_grads"] = {"w": np.array(gw), "x": np.array(gx)}
pickle.dump(out, open(sys.argv[2], "wb"))
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's results on 2 forced host devices (one
    subprocess): (a)'s init params, step-0 grads and step metrics, (e),
    (f) and (h)."""
    d = tmp_path_factory.mktemp("jax_dp")
    inp, outp = str(d / "in.pkl"), str(d / "out.pkl")
    with open(inp, "wb") as fh:
        pickle.dump({"batches": BATCHES, "int8": _int8_inputs(),
                     "moe": _moe_inputs(), "pipe": _pipe_inputs()}, fh)
    src = os.path.join(REPO_ROOT, "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_allow_excess_precision=false",
               PYTHONPATH=(src + os.pathsep + os.environ["PYTHONPATH"]
                           if os.environ.get("PYTHONPATH") else src))
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, inp, outp],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO_ROOT, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    with open(outp, "rb") as fh:
        return pickle.load(fh)


def _dense(jax_params=None, **kw):
    return dict(DENSE, params=jax_params, batches=BATCHES, **kw)


@pytest.fixture(scope="module")
def world(jax_ref, tmp_path_factory):
    """Every rank case on both ranks of one 2-rank world (one spawn)."""
    d = tmp_path_factory.mktemp("dp2")
    one_dir = str(d / "ckpt_one")
    _one_device_checkpoint(one_dir)
    cases = [
        ("dp_step:jax", _dense(jax_ref["params"])),
        ("dp_step:dp", _dense()),
        ("dp_step:mb", _dense(microbatches=2, grad_compress="bf16",
                              optimizer="adafactor")),
        ("dp_step:fsdp", _dense(fsdp=True)),
        ("dp_step:dp_af", _dense(optimizer="adafactor")),
        ("dp_step:fsdp_af", _dense(fsdp=True, optimizer="adafactor")),
        ("moe_ep", _moe_inputs()),
        ("moe_capacity:dp", dict(_moe_cap_payload(), ep=False)),
        ("moe_capacity:ep", dict(_moe_cap_payload(), ep=True)),
        ("int8", _int8_inputs()),
        ("pipeline", _pipe_inputs()),
        ("elastic_in", dict(DENSE, dir=one_dir)),
        ("serve_steps:dense", _serve_payload("dense")),
        ("serve_steps:moe", _serve_payload("moe")),
        ("trainer:straight", dict(DENSE, dir=str(d / "t_straight"),
                                  steps=[4], fsdp=True)),
        ("trainer:resumed", dict(DENSE, dir=str(d / "t_resumed"),
                                 steps=[2, 4], fsdp=True)),
    ]
    res = W.run_world(d, 2, cases, shape={"data": 2},
                      module="_torch_dp_worker")
    res["dirs"] = {"one": one_dir, "straight": str(d / "t_straight")}
    return res


def _moe_cap_payload():
    m = _moe_inputs()
    return dict(m, arch="deepseek-moe-16b",
                reduce=dict(layers=2, d_model=MOE["d"], vocab=128),
                replace=dict(n_experts=MOE["n_experts"],
                             experts_per_token=MOE["k"]), seq=16)


def _serve_payload(which):
    """A prefill of 4 rows of 32 tokens and a decode step from an empty
    cache: reduced qwen2 (dense) or deepseek-moe-16b (moe: the capacity
    route over the global batch's 128 tokens)."""
    arch = "qwen2-1.5b" if which == "dense" else "deepseek-moe-16b"
    return dict(arch=arch, reduce=dict(layers=2, d_model=64, vocab=128),
                seed=3, cache_len=64, tokens=_batch(6)["tokens"])


def _one_device_checkpoint(path):
    """A one-device Trainer's checkpoint after 2 steps (whole leaves)."""
    cfg = reduce_config(get_config(DENSE["arch"]), **DENSE["reduce"])
    loop = TrainLoopConfig(total_steps=2, ckpt_every=2, log_every=100,
                           ckpt_dir=path, seq_len=32, global_batch=4,
                           peak_lr=1e-3)
    Trainer(cfg, loop, device="cpu").run(verbose=False)


def _flat(tree, pre=""):
    return D._flat(tree, pre)


def _grads_close(got, want, rtol=GRAD_RTOL):
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.max(np.abs(np.asarray(got[path], np.float32) - w)))
        assert err <= rtol * float(np.max(np.abs(w))), (path, err)


def _ranks_bit_equal(world, name):
    r0, r1 = world[0][name], world[1][name]
    assert [s["digest"] for s in r0["steps"]] == \
        [s["digest"] for s in r1["steps"]]
    assert [s["metrics"] for s in r0["steps"]] == \
        [s["metrics"] for s in r1["steps"]]


def _losses(res):
    return [s["metrics"]["loss"] for s in res["steps"]]


# ---------------------------------------------------------------- (a)-(c)

def test_dp_step_matches_jax_sharded_step(world, jax_ref):
    got = world[0]["dp_step:jax"]
    want = [m["loss"] for m in jax_ref["metrics"]]
    np.testing.assert_allclose(_losses(got), want, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(
        [s["metrics"]["grad_norm"] for s in got["steps"]],
        [m["grad_norm"] for m in jax_ref["metrics"]], rtol=GRAD_RTOL)
    from repro_torch.models.convert import params_from_numpy
    cfg = reduce_config(get_config(DENSE["arch"]), **DENSE["reduce"])
    # the JAX grads in the port's layout
    jg = D._to_numpy(params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jax_ref["grads0"]), cfg, device="cpu"))
    _grads_close(got["steps"][0]["grads"], jg)
    _ranks_bit_equal(world, "dp_step:jax")


@pytest.mark.parametrize("name,one_device", [
    ("dp_step:dp", {}),
    ("dp_step:dp_af", dict(optimizer="adafactor")),
    ("dp_step:mb", dict(microbatches=2, grad_compress="bf16",
                        optimizer="adafactor")),
])
def test_dp_matches_one_device(world, name, one_device):
    ref = D.dp_step(None, _dense(**one_device))
    got = world[0][name]
    np.testing.assert_allclose(_losses(got), _losses(ref), atol=LOSS_ATOL,
                               rtol=0)
    for g, r in zip(got["steps"], ref["steps"]):
        _grads_close(g["grads"], r["grads"])
    _ranks_bit_equal(world, name)


@pytest.mark.parametrize("fsdp,dp", [("dp_step:fsdp", "dp_step:dp"),
                                     ("dp_step:fsdp_af", "dp_step:dp_af")])
def test_fsdp_matches_dp(world, fsdp, dp):
    got, ref = world[0][fsdp], world[0][dp]
    np.testing.assert_allclose(_losses(got), _losses(ref), atol=LOSS_ATOL,
                               rtol=0)
    for g, r in zip(got["steps"], ref["steps"]):
        _grads_close(g["grads"], r["grads"])
    _grads_close(got["params"], ref["params"])
    _ranks_bit_equal(world, fsdp)
    # FSDP keeps half of every split leaf on a rank
    whole = {k: v.shape for k, v in _flat(ref["params"]).items()}
    split = [k for k, s in got["local_shapes"].items() if s != whole[k]]
    assert split and all(
        np.prod(got["local_shapes"][k]) * 2 == np.prod(whole[k])
        for k in split)


# ------------------------------------------------------------------- (d)

class _Mesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = ({"data": 2}, {"data": 2, "model": 1}, {"pod": 2, "data": 16,
                                                  "model": 16})


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_plan_matches_reference(arch, kind):
    assert tuple(JARCH_IDS) == tuple(ARCH_IDS)
    for shape in MESHES:
        for over in ({}, dict(fsdp=True), dict(ep_data=False)):
            mine = step_lib.make_plan(get_config(arch), _Mesh(shape),
                                      kind=kind, **over)
            ref = jstep.make_plan(jget(arch), _Mesh(shape), kind=kind,
                                  **over)
            for f in ("dp_axes", "fsdp", "kv_seq_shard", "ep_data"):
                assert getattr(mine, f) == getattr(ref, f), (shape, over, f)
            assert mine.tp_axis == ref.tp_axis


# ------------------------------------------------------------------- (e)

def test_ef_int8_compress_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((8, 33)).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal((5,)).astype(np.float32)},
         "z": np.zeros((4,), np.float32)}
    r = {"a": rng.standard_normal((8, 33)).astype(np.float32) * 0.01,
         "b": {"c": np.zeros((5,), np.float32)}, "z": np.zeros((4,),
                                                               np.float32)}
    jq, js, jr = jcompress.ef_int8_compress(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    tq, ts, tr = compress.ef_int8_compress(
        jax.tree.map(torch.from_numpy, g), jax.tree.map(torch.from_numpy, r))
    for want, got in ((jq, tq), (js, ts), (jr, tr)):
        for k, w in _flat(jax.tree.map(np.asarray, want)).items():
            np.testing.assert_array_equal(_flat(got)[k].numpy(), w)
    deq = compress.ef_int8_decompress(tq, ts)
    jdeq = jcompress.ef_int8_decompress(jq, js)
    for k, w in _flat(jax.tree.map(np.asarray, jdeq)).items():
        np.testing.assert_array_equal(_flat(deq)[k].numpy(), w)


def test_allreduce_int8_bit_equal_to_jax(world, jax_ref):
    want = jax_ref["int8"]
    for r in (0, 1):
        got = world[r]["int8"]
        np.testing.assert_array_equal(got["out"],
                                      want["out"][8 * r:8 * r + 8])
        # XLA contracts gf - q * scale into one FMA under jit: one f32
        # rounding apart, within an ulp of the largest |gf|
        ulp = 2.0 ** -23 * np.abs(_int8_inputs()["g"]).max()
        assert np.abs(got["res"] - want["res"][8 * r:8 * r + 8]).max() <= ulp
    exact = _int8_inputs()["g"].mean(0)
    assert np.abs(world[0]["int8"]["out"] - exact).max() < 0.05


# ------------------------------------------------------------------- (f)

def _cat_ranks(world, name, split=()):
    """The two ranks' results of a moe case put together: rows and the
    `split` grads concatenated, the others (summed over the ranks) from
    rank 0, after checking both ranks hold the same."""
    r0, r1 = world[0][name], world[1][name]
    assert r0["aux"] == r1["aux"]
    gp = {}
    for k in r0["gp"]:
        if k in split:
            gp[k] = np.concatenate([r0["gp"][k], r1["gp"][k]])
        else:
            np.testing.assert_array_equal(r0["gp"][k], r1["gp"][k])
            gp[k] = r0["gp"][k]
    return {"out": np.concatenate([r0["out"], r1["out"]]), "aux": r0["aux"],
            "gx": np.concatenate([r0["gx"], r1["gx"]]), "gp": gp}


EXPERTS = ("wi", "wg", "wo")


def _emulated(payload):
    """moe_ffn_ep_emulated on the whole inputs in this process."""
    x = tensor_from_numpy(payload["x"], "cpu").requires_grad_(True)
    p = {k: tensor_from_numpy(v, "cpu").requires_grad_(True)
         for k, v in payload["params"].items()}
    out, aux = moe.moe_ffn_ep_emulated(x, p, n_experts=payload["n_experts"],
                                       k=payload["k"], n_shards=2)
    names = sorted(p)
    loss = (out.float() * torch.from_numpy(payload["cot"])).sum() \
        + payload["coef"] * aux
    g = torch.autograd.grad(loss, [x] + [p[k] for k in names])
    return {"out": out.detach().float().numpy(), "aux": float(aux.detach()),
            "gx": g[0].float().numpy(),
            "gp": {k: t.float().numpy() for k, t in zip(names, g[1:])}}


def _moe_close(got, want):
    scale = np.abs(want["out"]).max()
    assert np.abs(got["out"] - want["out"]).max() <= OUT_ULPS * scale
    assert abs(got["aux"] - want["aux"]) <= AUX_RTOL * abs(want["aux"])
    _grads_close({"gx": got["gx"], **got["gp"]},
                 {"gx": want["gx"], **want["gp"]})


def test_moe_ffn_ep_matches_jax_and_emulation(world, jax_ref):
    got = _cat_ranks(world, "moe_ep", EXPERTS)
    _moe_close(got, jax_ref["moe"])
    emu = _emulated(_moe_inputs())
    np.testing.assert_array_equal(got["out"], emu["out"])
    assert got["aux"] == emu["aux"]
    np.testing.assert_array_equal(got["gx"], emu["gx"])
    for k in EXPERTS:
        np.testing.assert_array_equal(got["gp"][k], emu["gp"][k])
    # the router's and shared experts' grads: the ranks' bf16 partials
    # summed here in f32, the emulation's in bf16 by autograd
    _grads_close(got["gp"], emu["gp"])


# ------------------------------------------------------------------- (g)

@pytest.mark.parametrize("name", ["moe_capacity:dp", "moe_capacity:ep"])
def test_global_capacity_route_is_the_global_function(world, name):
    payload = _moe_cap_payload()
    got = _cat_ranks(world, name, EXPERTS if name.endswith(":ep") else ())
    x = tensor_from_numpy(payload["x"], "cpu").requires_grad_(True)
    p = {k: tensor_from_numpy(v, "cpu").requires_grad_(True)
         for k, v in payload["params"].items()}
    out, aux = moe.moe_ffn(x, p, n_experts=payload["n_experts"],
                           k=payload["k"])
    names = sorted(p)
    loss = (out.float() * torch.from_numpy(payload["cot"])).sum() \
        + payload["coef"] * aux
    g = torch.autograd.grad(loss, [x] + [p[k] for k in names])
    np.testing.assert_array_equal(got["out"], out.detach().float().numpy())
    assert got["aux"] == pytest.approx(float(aux), rel=1e-6)
    _grads_close({"gx": got["gx"], **got["gp"]},
                 {"gx": g[0].float().numpy(),
                  **{k: t.float().numpy() for k, t in zip(names, g[1:])}})


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_prefill_and_decode_steps_over_data_ranks(world, which):
    """build_prefill_step and build_decode_step under make_plan's prefill
    and decode plans over the data axes: each rank's rows of the logits
    equal the one-device steps' on the global batch (a moe layer's
    capacity competes over the global batch, as in the reference), up to
    the f32 head's summation order at another row count: within 1e-5 of
    the largest |logit|."""
    ref = D.serve_steps(None, _serve_payload(which))
    for r in (0, 1):
        got = world[r][f"serve_steps:{which}"]
        for k in ("prefill", "decode"):
            want = ref[k][2 * r:2 * r + 2]
            assert np.abs(got[k] - want).max() <= 1e-5 * np.abs(want).max()
        # the decode cache's rows split over the data axis
        assert got["cache_specs"]["k"][1] == "data"


# ------------------------------------------------------------------- (h)

def test_pipelined_apply_matches_jax_and_dense(world, jax_ref):
    """The outputs against the dense scan and JAX's, and the gradient of
    sum(out * cot): each rank's stage grads against the dense loop's for
    its layers, the stream's (whole on both ranks) against the dense
    loop's; jax.grad through the reference's pipelined_apply gives the
    dense gradient too (ROADMAP queue 3)."""
    pi = _pipe_inputs()
    w = torch.from_numpy(pi["w"]).requires_grad_(True)
    x = torch.from_numpy(pi["x"]).requires_grad_(True)
    dense = x
    for i in range(w.shape[0]):
        dense = torch.tanh(dense @ w[i])
    gw, gx = torch.autograd.grad((dense * torch.from_numpy(pi["cot"])).sum(),
                                 [w, x])
    dense = dense.detach().numpy()
    half = w.shape[0] // 2
    for r in (0, 1):
        got = world[r]["pipeline"]
        assert np.abs(got["out"] - dense).max() < PIPE_ATOL
        assert np.abs(got["out"] - jax_ref["pipe"]).max() < PIPE_ATOL
        stage = gw[r * half:(r + 1) * half].numpy()
        assert np.abs(got["gw"] - stage).max() < PIPE_ATOL
        assert np.abs(got["gx"] - gx.numpy()).max() < PIPE_ATOL
    for k in ("out", "gx"):
        np.testing.assert_array_equal(world[0]["pipeline"][k],
                                      world[1]["pipeline"][k])
    jg = jax_ref["pipe_grads"]
    assert np.abs(jg["w"] - gw.numpy()).max() < PIPE_ATOL
    assert np.abs(jg["x"] - gx.numpy()).max() < PIPE_ATOL
    from repro.dist.pipeline import bubble_fraction as jbubble
    for s, m in ((4, 4), (2, 8), (1, 3), (8, 1)):
        assert pipeline.bubble_fraction(s, m) == jbubble(s, m)


# ------------------------------------------------------------------- (i)

def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_elastic_checkpoint_one_to_two(world):
    step, state = CheckpointManager(world["dirs"]["one"]).restore(
        device="cpu")
    whole = _flat(state)
    for r in (0, 1):
        got = world[r]["elastic_in"]
        assert got["step"] == 2
        specs = got["specs"]
        mesh = types.SimpleNamespace(shape={"data": 2}, coords={"data": r})
        split = 0
        for k, t in got["state"].items():
            want = sharding.local_shard(whole[k], tuple(specs.get(k, ())),
                                        mesh)
            split += want.shape != whole[k].shape
            assert torch.equal(_bits(t), _bits(want)), k
        assert split > 0


def test_elastic_checkpoint_two_to_one(world):
    step, state = CheckpointManager(world["dirs"]["straight"]).restore(
        device="cpu")
    assert step == 4
    ranks = world[0]["trainer:straight"]["state"]
    assert ranks.keys() == world[1]["trainer:straight"]["state"].keys()
    for k, t in _flat(state).items():
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy(), ranks[k])
    # one more step on one device from the restored state
    cfg = reduce_config(get_config(DENSE["arch"]), **DENSE["reduce"])
    bundle, _ = step_lib.build_train_step(build_model(cfg), **D.STEP_KW)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    _, _, m = bundle(state["params"], state["opt"], batch)
    assert np.isfinite(float(m["loss"]))


# ------------------------------------------------------------------- (j)

def test_trainer_resume_matches_straight_run(world):
    for r in (0, 1):
        straight = world[r]["trainer:straight"]["runs"]
        resumed = world[r]["trainer:resumed"]["runs"]
        assert [x["start"] for x in resumed] == [0, 2]
        assert resumed[0]["losses"] + resumed[1]["losses"] == \
            straight[0]["losses"]
    assert world[0]["trainer:straight"]["runs"] == \
        world[1]["trainer:straight"]["runs"]
    a, b = world[0]["trainer:resumed"]["state"], \
        world[0]["trainer:straight"]["state"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_trainer_refuses_a_model_axis(tmp_path, monkeypatch):
    """Every family trains over a model axis (tests/test_torch_tp_train.py),
    and beside FSDP since the port executes a dim split over the model
    axis and the data axes together: hymba with fsdp=True on {"data": 2,
    "model": 2} builds (its packed in_proj co-split, the groups over
    "data" and "model"). What the Trainer still refuses, before it makes a
    process group, is a spec spec_for never makes: here the data axis
    before the model axis on in_proj's last dim."""
    from repro_torch.dist import collectives
    cfg = reduce_config(get_config("hymba-1.5b"), **DENSE["reduce"])
    loop = TrainLoopConfig(ckpt_dir=str(tmp_path / "ckpt"))
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2}, rank=0,
                                 size=4, coords={"data": 0, "model": 0},
                                 device=torch.device("cpu"))
    made = []

    class Group:                      # no process group on this side
        def __init__(self, mesh, axes):
            self.axes, self.size, self.index = tuple(axes), 2, 0
            made.append(self.axes)

    monkeypatch.setattr(collectives, "AxesGroup", Group)
    tr = Trainer(cfg, loop, mesh, fsdp=True)
    spec = tr._specs()["params"]["layers"]["mamba"]["in_proj"]
    assert tr.plan.fsdp and sharding.spec_parts(spec) == 2
    assert tuple(spec) == (None, None, ("model", "data"))
    assert sorted(made) == [("data",), ("model",)]
    real = sharding.params_shardings

    def data_first(*a, **kw):
        specs = real(*a, **kw)
        specs["layers"]["mamba"]["in_proj"] = sharding.PackedSpec(
            (None, None, ("data", "model")), 2)
        return specs

    monkeypatch.setattr(sharding, "params_shardings", data_first)
    made.clear()
    with pytest.raises(NotImplementedError, match="the model axis first"):
        Trainer(cfg, loop, mesh, fsdp=True)
    assert made == []


def test_dp_needs_rows_that_split():
    plan = step_lib.make_plan(
        reduce_config(get_config(DENSE["arch"]), **DENSE["reduce"]),
        types.SimpleNamespace(shape={"data": 2}, coords={"data": 0}),
        kind="train")
    with pytest.raises(ValueError):
        sharding.local_batch(plan, {"tokens": torch.zeros(3, 4)})
    assert dataclasses.is_dataclass(plan)
