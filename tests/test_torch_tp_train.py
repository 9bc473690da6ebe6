"""Tensor-parallel training in the port (ROADMAP items 9.4 and 9.5)
against the port's one-device step and the JAX package's unsharded step:
every rank case runs in one 4-rank gloo world on the CPU over a {"data":
2, "model": 2} mesh (tests/_torch_tp_worker.run_world, the cases in
tests/_torch_tp_train_worker.py), the one-device references in this
process, and the JAX references in two subprocesses with 4 forced host
devices (the dense and moe ones; the other four families'), started
before the world and run beside it.

Sizes: reduced qwen2 (2 layers, d_model 64, vocab 128, 12 heads and 2 kv
heads of 16: a rank holds 6 and 1, qwen2-1.5b's TP 2 layout) and reduced
deepseek-moe (2 layers, 8 experts, 2 heads and 2 kv heads). Every dim the
plan splits over "model" is even, so each split happens ((e) asserts
it). Tolerances are tests/test_torch_dist_train.py's: LOSS_ATOL
on the losses, GRAD_RTOL of each leaf's max |grad| on every grad leaf of
every step (of step 0 in the moe cases: MOE_GRAD_STEPS). The row-parallel partials are bf16 summed over the ranks, as
the reference's bf16 psum (matmul_rp, moe.py:166), so the TP step is one
bf16 rounding from the unsharded one.

  (a) AdamW, 2 steps, on the JAX package's init weights: against the
      port's one-device step, and against the JAX package's unsharded
      step (value_and_grad of loss_fn + the optimizer) in losses, grad
      norms and step 0's grads; and against the reference's own TP step
      on a ("model", 2) mesh of host devices, which runs on this jax, in
      losses and grad norms;
  (b) the same with Adafactor; (c) with microbatches 2 and bf16 grads;
      and two head layouts split off the head boundaries (half a kv head,
      a head and a half a rank) against the one-device step;
  (d) reduced deepseek-moe on the expert-parallel route (4096 global
      tokens, every token to every expert: every moe layer takes
      moe_ffn_ep with has_tp) against the one-device step whose moe
      layers run moe_ffn_ep_emulated over 2 x 2 ranks, and on the
      capacity route (128 tokens, k = 2) against the plain one-device
      step, each step's grads leaf by leaf at step 0 (see
      MOE_GRAD_STEPS); moe_ffn_ep's has_tp branch alone against JAX's
      moe_ffn_ep on a 2 x 2 mesh where that runs, and bit for bit against
      moe_ffn_ep_emulated(tp_shards=2);
  (e) the local shapes (half of wq's columns, wo's rows, the embedding's
      vocab rows, the experts' d_ff), replicated leaves bit-equal across
      the model ranks after every step and replicas across the data ranks;
  (f) a Trainer checkpoint of the 2 x 2 world (whole leaves) restored bit
      for bit onto its ranks, on one device (then one more step), and
      into TP 2's blocks;
  (g) the hybrid, ssm, encdec and vlm families (FAMILIES: reduced
      hymba-1.5b at d_model 160, 5 heads and 1 kv head of 32, so wq's 160
      columns split at 80, two and a half heads a rank, as hymba-1.5b's 25
      heads at TP 2, with the windowed attention biting at S = 128 and
      four mamba leaves scaled so the scan moves the loss (ACTIVE);
      reduced rwkv6-7b at d_model
      128, 4 heads of 32, vocab 128 (split: a vocab-parallel embedding and
      loss); reduced whisper-small at d_model 128, 4 heads, on f32 frames;
      reduced internvl2-26b at d_model 384, 12 heads and 2 kv heads (6 and
      1 a rank) with flash on and 8 vis + 248 text = 256 positions, so the
      flash route's plain version runs on a rank's heads, Adafactor;
      hymba, whisper and internvl2 at an odd vocab, 127, whose table and
      head stay whole on every rank), 2 steps each on the JAX package's
      weights: against the port's one-device step and the JAX package's
      unsharded step (losses, grad norms, step 0's grads; each step's
      grads are held at step 0 only, FAMILY_GRAD_STEPS), and against the
      reference's own TP step over ("model", 2), which runs on this jax
      for all four (losses and grad norms); the splits and replicas as
      (e); a hymba Trainer checkpoint of the 2 x 2 world restored bit for
      bit onto its ranks, one device and TP 2's blocks, whose in_proj
      keeps the rank's block of xs beside its block of z
      (sharding.PackedSpec); and hymba with ssm_impl "pallas" under TP
      raising in its backward, as on one device.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import _torch_dp_worker as D
import _torch_tp_train_worker as TW
import _torch_tp_worker as W
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.dist import sharding
from repro_torch.models import moe, registry
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train import step as step_lib

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
OUT_ULPS = 2 * 2.0 ** -8
AUX_RTOL = 1e-5
SHAPE = {"data": 2, "model": 2}
REDUCE = dict(layers=2, d_model=64, vocab=128)
QWEN_HEADS = dict(n_heads=12, n_kv_heads=2, head_dim=16)
DENSE = dict(arch="qwen2-1.5b", reduce=REDUCE, replace=QWEN_HEADS, seed=0)
MOE_CFG = dict(arch="deepseek-moe-16b", reduce=REDUCE, seed=1)
OPTS = {"adamw": dict(optimizer="adamw", microbatches=1,
                      grad_compress="none"),
        "adafactor": dict(optimizer="adafactor", microbatches=1,
                          grad_compress="none"),
        "mb": dict(optimizer="adamw", microbatches=2, grad_compress="bf16")}
MOE = dict(n_experts=8, k=2, d=64, f=32, t=128, coef=0.1)
# (g): the other four families, each with its sequence length
FAMILIES = {
    "hybrid": dict(arch="hymba-1.5b", seed=0, seq=128,
                   reduce=dict(layers=2, d_model=160, vocab=127)),
    "ssm": dict(arch="rwkv6-7b", seed=0, seq=64,
                reduce=dict(layers=2, d_model=128, vocab=128)),
    "encdec": dict(arch="whisper-small", seed=0, seq=32,
                   reduce=dict(layers=2, d_model=128, vocab=127)),
    "vlm": dict(arch="internvl2-26b", seed=0, seq=248,
                reduce=dict(layers=2, d_model=384, vocab=127),
                replace=dict(use_flash_attention=True)),
}
# hymba's mamba leaves scaled so the scan moves the loss (by 9e-3 at step
# 0) and its grads. tests/test_torch_hybrid_train.py's larger factors (x5,
# x25, x10, x10, made for d_model 64) leave d_model 160 ill-conditioned:
# there one device's chunked and sequential scans give grads 20x their
# max apart; at these factors 5e-4, while a 2^-8 change of the embedding
# moves them 2.5%
ACTIVE = {"in_proj": 2.0, "conv_w": 5.0, "x_proj": 3.0, "dt_proj": 3.0}
# AdamW's first update is +-lr for every element whatever its grad's size
# (and Adafactor's first is its clipped RMS step), so an element whose
# grad is near 0 and of the other sign in the TP run moves 2 lr apart:
# every leaf of these families has such elements, and step 1's grads of
# the leaves with small grads (rwkv6's decay w0, whisper's encoder wo) then
# lie up to 98% of their max apart. Step 1 is held in its loss and grad
# norm; the grads at step 0, where both runs start from the same params.
FAMILY_GRAD_STEPS = 1
# whisper's encoder FFN biases: their grads sum B x enc_seq = 256 bf16
# cotangents, and JAX's are 5.6% and 9.0% of the largest (layers 0 and 1,
# bo) from the float64 sum of the port's same cotangents, the port's f32
# sums 0.23% (the one-device port is as far from JAX there as the TP step).
# Against JAX they are held only through the one-device step; every other
# leaf is held to JAX directly (ROADMAP queue 3)
JAX_BF16_SUMS = {"encdec": ("enc_layers/ffn/bi", "enc_layers/ffn/bo")}


def _batch(seed, b=4, s=32, vocab=128):
    """tokens/labels (B, S) int32; a few labels -1 (out of the loss)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :7] = -1
    labels[b - 1, 10:15] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


BATCHES = [_batch(0), _batch(1)]


def _family_batches(name):
    """FAMILIES[name]'s two batches: _batch at its length and vocab, with
    whisper's f32 frames or internvl2's patch embeddings (N(0, 1) x 0.02,
    f32, the Trainer's stub inputs)."""
    f = FAMILIES[name]
    out = []
    for seed in (0, 1):
        b = _batch(seed, s=f["seq"], vocab=f["reduce"]["vocab"])
        rng = np.random.default_rng(10 + seed)
        d = f["reduce"]["d_model"]
        if name == "encdec":
            b["frames"] = (0.02 * rng.standard_normal((4, 64, d))).astype(
                np.float32)
        if name == "vlm":
            b["vis"] = (0.02 * rng.standard_normal((4, 8, d))).astype(
                np.float32)
        out.append(b)
    return out
# global token counts: 4096 takes the expert-parallel route, 128 the
# capacity route (registry.EP_MIN_TOKENS)
EP_BATCHES = [_batch(2, b=16, s=256), _batch(3, b=16, s=256)]
assert 16 * 256 >= registry.EP_MIN_TOKENS > 4 * 32


def _bf16(a):
    return tensor_from_numpy(np.asarray(a, np.float32), "cpu").bfloat16(
    ).float().numpy()


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
            "params": p, "n_experts": e, "k": MOE["k"], "coef": MOE["coef"],
            "as_bf16": True}


JAX_SCRIPT = r'''
import dataclasses, functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config, reduce_config
from repro.models import moe
from repro.models.registry import build_model
from repro.optim.adafactor import make_optimizer
from repro.optim.schedule import linear_warmup_cosine
from repro.train import step as step_lib

inp = pickle.load(open(sys.argv[1], "rb"))
out = {}
kw = inp["step_kw"]
cfg = dataclasses.replace(reduce_config(get_config("qwen2-1.5b"),
                                        **inp["reduce"]), **inp["replace"])
model = build_model(cfg)
params0 = jax.tree.map(jnp.asarray, inp["params"])
batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in inp["batches"]]


def lr_fn():
    return functools.partial(linear_warmup_cosine, peak_lr=kw["peak_lr"],
                             warmup=kw["warmup"], total=kw["total_steps"])


# (a)-(c): the unsharded step, value_and_grad of loss_fn + the optimizer
grad_fn = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
for name, o in inp["opts"].items():
    opt = make_optimizer(o["optimizer"], lr_fn())
    update = jax.jit(opt.update)
    p, st, mets, grads0 = params0, opt.init(params0), [], None
    n = o["microbatches"]
    for b in batches:
        g, ms = None, []
        for i in range(n):
            (_, m), gi = grad_fn(p, {k: v[i::n] for k, v in b.items()})
            if n > 1:
                gi = jax.tree.map(lambda x: x.astype(jnp.float32) / n, gi)
            g = gi if g is None else jax.tree.map(jnp.add, g, gi)
            ms.append(m)
        if o["grad_compress"] == "bf16":
            g = jax.tree.map(lambda x: x.astype(jnp.bfloat16), g)
        if grads0 is None:
            grads0 = jax.tree.map(lambda x: np.array(x.astype(jnp.float32)),
                                  g)
        p, st, om = update(p, g, st)
        mets.append({"loss": float(np.mean([float(m["loss"]) for m in ms])),
                     "grad_norm": float(om["grad_norm"])})
    out[name] = {"metrics": mets, "grads0": grads0}


def attempt(fn):
    try:
        return {"ok": fn()}
    except Exception as e:
        return {"error": type(e).__name__,
                "message": (str(e).strip().splitlines() or [""])[0][:300]}


# (a): the reference's own TP step over ("model", 2)
def tp_step():
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    plan = step_lib.make_plan(cfg, mesh, kind="train")
    bundle, opt = step_lib.build_train_step(
        model, plan, peak_lr=kw["peak_lr"], warmup=kw["warmup"],
        total_steps=kw["total_steps"])
    with jax.set_mesh(mesh):
        params = jax.device_put(params0, bundle.in_shardings[0])
        state = jax.jit(opt.init, out_shardings=bundle.in_shardings[1])(
            params)
        step = jax.jit(bundle.fn,
                       in_shardings=bundle.in_shardings[:2] + (None,),
                       out_shardings=bundle.out_shardings)
        mets = []
        for b in batches:
            params, state, m = step(params, state, b)
            mets.append({k: float(v) for k, v in m.items()})
    return mets


out["tp_step"] = attempt(tp_step)


# (d): moe_ffn_ep's has_tp branch on a ("data", 2) x ("model", 2) mesh
def moe_tp():
    mi = inp["moe"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    specs = {"wi": P("data", None, "model"), "wg": P("data", None, "model"),
             "wo": P("data", "model", None)}
    x = jnp.asarray(mi["x"], jnp.bfloat16)
    p = {k: jnp.asarray(v, jnp.bfloat16) for k, v in mi["params"].items()}
    cot = jnp.asarray(mi["cot"])

    def f(x, p):
        o, aux = moe.moe_ffn_ep(x, p, n_experts=mi["n_experts"], k=mi["k"],
                                mesh=mesh, dp_axes=("data",))
        return (o.astype(jnp.float32) * cot).sum() + mi["coef"] * aux, (o,
                                                                       aux)

    with jax.set_mesh(mesh):
        xd = jax.device_put(x, NamedSharding(mesh, P("data")))
        pd = {k: jax.device_put(v, NamedSharding(mesh, specs.get(k, P())))
              for k, v in p.items()}
        (_, (o, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(xd, pd)
    return {"out": np.array(o.astype(jnp.float32)), "aux": float(aux),
            "gx": np.array(gx.astype(jnp.float32)),
            "gp": {k: np.array(v.astype(jnp.float32)) for k, v in gp.items()}}


out["moe_tp"] = attempt(moe_tp)
pickle.dump(out, open(sys.argv[2], "wb"))
'''


FAMILY_SCRIPT = r'''
import dataclasses, functools, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config, reduce_config
from repro.models.registry import build_model
from repro.optim.adafactor import make_optimizer
from repro.optim.schedule import linear_warmup_cosine
from repro.train import step as step_lib

inp = pickle.load(open(sys.argv[1], "rb"))
kw = inp["step_kw"]
lr_fn = functools.partial(linear_warmup_cosine, peak_lr=kw["peak_lr"],
                          warmup=kw["warmup"], total=kw["total_steps"])


def attempt(fn):
    try:
        return {"ok": fn()}
    except Exception as e:
        return {"error": type(e).__name__,
                "message": (str(e).strip().splitlines() or [""])[0][:300]}


def family(f):
    cfg = dataclasses.replace(reduce_config(get_config(f["arch"]),
                                            **f["reduce"]),
                              **f.get("replace", {}))
    model = build_model(cfg)
    params0 = jax.tree.map(jnp.asarray, f["params"])
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in f["batches"]]
    # the unsharded step: value_and_grad of loss_fn + cfg's optimizer
    grad_fn = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
    opt = make_optimizer(cfg.optimizer, lr_fn)
    update = jax.jit(opt.update)
    p, st, mets, grads0 = params0, opt.init(params0), [], None
    for b in batches:
        (_, m), g = grad_fn(p, b)
        if grads0 is None:
            grads0 = jax.tree.map(lambda x: np.array(x.astype(jnp.float32)),
                                  g)
        p, st, om = update(p, g, st)
        mets.append({"loss": float(m["loss"]),
                     "grad_norm": float(om["grad_norm"])})

    # the reference's own TP step over ("model", 2)
    def tp_step():
        mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
        plan = step_lib.make_plan(cfg, mesh, kind="train")
        bundle, topt = step_lib.build_train_step(
            model, plan, peak_lr=kw["peak_lr"], warmup=kw["warmup"],
            total_steps=kw["total_steps"])
        with jax.set_mesh(mesh):
            params = jax.device_put(params0, bundle.in_shardings[0])
            state = jax.jit(topt.init, out_shardings=bundle.in_shardings[1])(
                params)
            step = jax.jit(bundle.fn,
                           in_shardings=bundle.in_shardings[:2] + (None,),
                           out_shardings=bundle.out_shardings)
            out = []
            for b in batches:
                params, state, m = step(params, state, b)
                out.append({k: float(v) for k, v in m.items()})
        return out

    return {"metrics": mets, "grads0": grads0, "tp_step": attempt(tp_step)}


out = {name: family(f) for name, f in inp["families"].items()}
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def _jax_env():
    src = os.path.join(REPO_ROOT, "src")
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                          "--xla_allow_excess_precision=false",
                PYTHONPATH=(src + os.pathsep + os.environ["PYTHONPATH"]
                            if os.environ.get("PYTHONPATH") else src))


@pytest.fixture(scope="module")
def family_params():
    """The JAX package's init of each reduced family (numpy leaves; hymba's
    ACTIVE mamba leaves scaled), the weights both packages train."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduce_config as jreduce
    from repro.models.registry import build_model as jbuild
    out = {}
    for name, f in FAMILIES.items():
        jcfg = dataclasses.replace(jreduce(jget(f["arch"]), **f["reduce"]),
                                   **f.get("replace", {}))
        p = jax.tree.map(np.array,
                         jbuild(jcfg).init_params(jax.random.PRNGKey(0)))
        if name == "hybrid":
            mp = p["layers"]["mamba"]
            for k, scale in ACTIVE.items():
                mp[k] = (mp[k].astype(np.float32) * scale).astype(
                    mp[k].dtype)
        out[name] = p
    return out


def _family(name, params):
    f = FAMILIES[name]
    return dict(arch=f["arch"], reduce=f["reduce"],
                replace=f.get("replace", {}), seed=f["seed"], params=params,
                batches=_family_batches(name))


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's init of the reduced qwen2 (numpy leaves), the
    weights both packages train."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import reduce_config as jreduce
    from repro.models.registry import build_model as jbuild
    jcfg = dataclasses.replace(jreduce(jget(DENSE["arch"]), **REDUCE),
                               **QWEN_HEADS)
    return jax.tree.map(np.array,
                        jbuild(jcfg).init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_proc(jax_params, tmp_path_factory):
    """The JAX references' subprocess (4 forced host devices), started
    here so it runs while the rank world does: (a)-(c)'s unsharded steps,
    the reference TP step's outcome and (d)'s moe_ffn_ep on 2 x 2."""
    d = tmp_path_factory.mktemp("jax_tp")
    inp, outp = str(d / "in.pkl"), str(d / "out.pkl")
    with open(inp, "wb") as fh:
        pickle.dump({"batches": BATCHES, "reduce": REDUCE,
                     "replace": QWEN_HEADS, "opts": OPTS,
                     "params": jax_params, "step_kw": D.STEP_KW,
                     "moe": _moe_inputs()}, fh)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, inp, outp],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO_ROOT, env=_jax_env())
    yield proc, outp
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def family_proc(family_params, tmp_path_factory):
    """(g)'s JAX references' subprocess (4 forced host devices): each
    family's unsharded steps and the reference's own TP step."""
    d = tmp_path_factory.mktemp("jax_tp_families")
    inp, outp = str(d / "in.pkl"), str(d / "out.pkl")
    with open(inp, "wb") as fh:
        pickle.dump({"step_kw": D.STEP_KW, "families": {
            name: _family(name, family_params[name]) for name in FAMILIES}},
            fh)
    proc = subprocess.Popen([sys.executable, "-c", FAMILY_SCRIPT, inp, outp],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO_ROOT, env=_jax_env())
    yield proc, outp
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _result(proc_out):
    proc, outp = proc_out
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    with open(outp, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    return _result(jax_proc)


@pytest.fixture(scope="module")
def family_ref(family_proc):
    return _result(family_proc)


# (h): FSDP beside the model axis. Reduced qwen2.5-32b keeps its GQA
# ratio (10 heads and 2 kv heads of 16: 5 and 1 a rank, qwen2.5-32b's
# group of 5) and Adafactor; the reduced model is under 8e9 params, so its
# default plan is DP x TP ("tp_step:qwen25") and fsdp=True forces FSDP
QWEN25 = dict(arch="qwen2.5-32b", reduce=REDUCE, seed=3,
              replace=dict(n_heads=10, n_kv_heads=2, head_dim=16))
# each FSDP x TP case (fsdp=True) and the DP x TP case of the same model,
# weights and batches on the same mesh
FSDP_CASES = {"dense": "tp_step:adamw", "moe": "tp_step:moe_cap",
              "hybrid": "tp_step:hybrid", "ssm": "tp_step:ssm",
              "encdec": "tp_step:encdec", "vlm": "tp_step:vlm",
              "qwen25": "tp_step:qwen25"}
# the world's 4 ranks run every case in turn (~2 min on 8 cores with the
# JAX subprocesses beside them): the FSDP cases double the TP ones
WORLD_TIMEOUT_S = 480.0


def _fsdp_payload(name, jax_params, family_params):
    """FSDP_CASES[name]'s payload with fsdp=True: the DP x TP case's
    model, weights and batches."""
    if name == "dense":
        return _dense(jax_params, fsdp=True, **OPTS["adamw"])
    if name == "moe":
        return _moe(BATCHES, fsdp=True)
    if name == "qwen25":
        return dict(QWEN25, batches=BATCHES, fsdp=True)
    return dict(_family(name, family_params[name]), fsdp=True)


def _dense(params=None, batches=BATCHES, **kw):
    return dict(DENSE, params=params, batches=batches, **kw)


def _moe(batches, **kw):
    return dict(MOE_CFG, batches=batches, **kw)


@pytest.fixture(scope="module")
def world(jax_proc, family_proc, jax_params, family_params,
          tmp_path_factory):
    """Every rank case on the 4 ranks of one 2 x 2 world (one spawn)."""
    d = tmp_path_factory.mktemp("tp4")
    cases = [(f"tp_step:{name}", _dense(jax_params, **OPTS[name]))
             for name in OPTS]
    cases += [(f"tp_step:{name}", dict(DENSE, replace=heads, params=None,
                                       batches=BATCHES))
              for name, heads in LAYOUTS.items()]
    cases += [("tp_step:moe_ep", _moe(EP_BATCHES, replace=EP_ALL_EXPERTS)),
              ("tp_step:moe_cap", _moe(BATCHES)),
              ("moe_ep_tp", _moe_inputs()),
              ("tp_trainer", dict(DENSE, dir=str(d / "ckpt"), steps=2))]
    cases += [(f"tp_step:{name}", _family(name, family_params[name]))
              for name in FAMILIES]
    hy = _family("hybrid", family_params["hybrid"])
    cases += [("tp_trainer:hybrid", dict(hy, params=None,
                                         dir=str(d / "ckpt_hybrid"),
                                         steps=2))]
    # (h): FSDP beside the model axis
    cases += [(f"tp_step:fsdp_{name}",
               _fsdp_payload(name, jax_params, family_params))
              for name in FSDP_CASES]
    cases += [("tp_step:qwen25", dict(QWEN25, batches=BATCHES))]
    cases += [(f"tp_trainer:fsdp_{name}",
               dict(payload, params=None, fsdp=True,
                    dir=str(d / f"ckpt_fsdp_{name}"), steps=2))
              for name, payload in (("qwen25", QWEN25), ("hybrid", hy))]
    cases += [("restore_step:tp_into_fsdp",
               dict(DENSE, dir=str(d / "ckpt"), fsdp=True,
                    batches=[_batch(4)])),
              # last: its backward raises on every rank
              ("tp_pallas", hy)]
    res = W.run_world(d, 4, cases, shape=SHAPE,
                      module="_torch_tp_train_worker",
                      timeout_s=WORLD_TIMEOUT_S)
    res["dir"] = str(d / "ckpt")
    res["dir_hybrid"] = str(d / "ckpt_hybrid")
    res["dir_fsdp"] = {name: str(d / f"ckpt_fsdp_{name}")
                       for name in ("qwen25", "hybrid")}
    return res


# the one-device runs, by model: a DP x TP case and its FSDP x TP case
# share one (dp_step without a mesh ignores payload["fsdp"])
_ONE_DEVICE = {}


def _one_device(key, payload):
    """D.dp_step(None, payload), run once a module for each key."""
    if key not in _ONE_DEVICE:
        _ONE_DEVICE[key] = D.dp_step(None, payload)
    return _ONE_DEVICE[key]


def _grads_close(got, want, rtol=GRAD_RTOL):
    want, got = D._flat(want), D._flat(got)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.max(np.abs(np.asarray(got[path], np.float32) - w)))
        assert err <= rtol * float(np.max(np.abs(w))), (path, err)


def _losses(res):
    return [s["metrics"]["loss"] for s in res["steps"]]


def _same_on_all_ranks(world, name):
    """Every rank computed the same metrics and whole grads."""
    r0 = world[0][name]
    for r in (1, 2, 3):
        assert [s["metrics"] for s in world[r][name]["steps"]] == \
            [s["metrics"] for s in r0["steps"]]


def _held_to_one_device(got, ref, grad_steps=None):
    """Losses and grad norms of every step; every grad leaf of the first
    `grad_steps` steps (all by default)."""
    np.testing.assert_allclose(_losses(got), _losses(ref), atol=LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        [s["metrics"]["grad_norm"] for s in got["steps"]],
        [s["metrics"]["grad_norm"] for s in ref["steps"]], rtol=GRAD_RTOL)
    for g, r in list(zip(got["steps"], ref["steps"]))[:grad_steps]:
        _grads_close(g["grads"], r["grads"])


# -------------------------------------------------------------- (a)-(c)

@pytest.mark.parametrize("name", list(OPTS))
def test_tp_step_matches_one_device_and_jax(world, jax_ref, jax_params,
                                            name):
    got = world[0][f"tp_step:{name}"]
    ref = _one_device(f"dense:{name}", _dense(jax_params, **OPTS[name]))
    _held_to_one_device(got, ref)
    want = jax_ref[name]
    np.testing.assert_allclose(_losses(got),
                               [m["loss"] for m in want["metrics"]],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(
        [s["metrics"]["grad_norm"] for s in got["steps"]],
        [m["grad_norm"] for m in want["metrics"]], rtol=GRAD_RTOL)
    cfg = D._cfg(DENSE)
    jg = D._to_numpy(params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), want["grads0"]),
        cfg, device="cpu"))
    _grads_close(got["steps"][0]["grads"], jg)
    _same_on_all_ranks(world, f"tp_step:{name}")


# head layouts a model axis of 2 splits off the head boundaries (spec_for
# splits a dim wherever the axis divides its size): wk's 32 columns into
# half a kv head a rank (reduced qwen2 as reduce_config makes it: 2 heads,
# 1 kv head of 32; qwen2-1.5b's layout at TP 4), and wq's 48 into a head
# and a half (3 heads of 16)
LAYOUTS = {"kv_part": dict(n_heads=2, n_kv_heads=1, head_dim=32),
           "q_part": dict(n_heads=3, n_kv_heads=1, head_dim=16)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tp_step_off_head_boundaries(world, name):
    """A rank's wk (and in q_part its wq) holds part of a head: k and v (q
    too) are gathered whole over the model group, and the step holds to
    the one-device step as the head-aligned one does."""
    got = world[0][f"tp_step:{name}"]
    heads = LAYOUTS[name]
    local = got["local_shapes"]
    assert local["layers/attn/wk"][-1] * 2 == heads["n_kv_heads"] * \
        heads["head_dim"]
    assert local["layers/attn/wk"][-1] % heads["head_dim"]
    assert (local["layers/attn/wq"][-1] % heads["head_dim"] != 0) == \
        (name == "q_part")
    _held_to_one_device(got, D.dp_step(None, dict(DENSE, replace=heads,
                                                  params=None,
                                                  batches=BATCHES)))
    _same_on_all_ranks(world, f"tp_step:{name}")


def test_reference_tp_step_matches_the_port(world, jax_ref):
    """The reference's own TP step (make_plan + build_train_step over a
    ("model", 2) mesh of host devices; it runs on this jax, ROADMAP queue
    3) against the port's TP step and the unsharded step: losses within
    LOSS_ATOL, grad norms within GRAD_RTOL. Where it raises, the error
    class is what it gives."""
    out = jax_ref["tp_step"]
    assert "ok" in out, out
    got = world[0]["tp_step:adamw"]["steps"]
    for want in (out["ok"], jax_ref["adamw"]["metrics"]):
        np.testing.assert_allclose([s["metrics"]["loss"] for s in got],
                                   [m["loss"] for m in want],
                                   atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose([s["metrics"]["grad_norm"] for s in got],
                                   [m["grad_norm"] for m in want],
                                   rtol=GRAD_RTOL)


# ------------------------------------------------------------------- (d)

# The moe steps' grads are held leaf by leaf at step 0, where the TP and
# one-device runs start from the same params. AdamW's first update is
# +-lr for every element whatever its grad's size, so an element whose
# grad is near 0 and of the other sign in one run moves 2 lr apart, and
# the router's top-k and capacity cuts then pick other tokens at step 1:
# a leaf's grad is then up to 32% of its max apart (reduced deepseek,
# k = 2). Step 1 is held in its loss and grad norm.
MOE_GRAD_STEPS = 1
# The expert-parallel route at model level routes every token to every
# expert (k = E: at 4096 tokens no capacity drops either), so the two runs
# route alike: at k = 2 a top-2 of 8 near-uniform router probabilities
# flips wherever the TP step's one-ulp activations cross a near tie, and
# at 4096 tokens enough tokens flip to move the experts' grads 13-17% of
# their max at step 0. The routing itself (k = 2, capacity drops) is held
# bit for bit at layer level (test_moe_ffn_ep_has_tp_matches_jax_and_
# emulation), and the capacity route here keeps k = 2.
EP_ALL_EXPERTS = dict(experts_per_token=8)

def test_moe_ep_route_matches_emulated_one_device(world):
    got = world[0]["tp_step:moe_ep"]
    n_moe = 1                        # reduce_config keeps one moe layer
    # every moe layer of every step on moe_ffn_ep with has_tp
    for r in range(4):
        routes = world[r]["tp_step:moe_ep"]["routes"]
        assert routes["moe_ffn"] == 0
        assert routes["moe_ffn_ep"] == routes["moe_ffn_ep_tp"] == \
            n_moe * len(EP_BATCHES)
    with TW.emulated_ep(n_shards=2, tp_shards=2):
        ref = D.dp_step(None, _moe(EP_BATCHES, replace=EP_ALL_EXPERTS))
    _held_to_one_device(got, ref, grad_steps=MOE_GRAD_STEPS)
    _same_on_all_ranks(world, "tp_step:moe_ep")


def test_moe_capacity_route_matches_one_device(world):
    got = world[0]["tp_step:moe_cap"]
    routes = got["routes"]
    assert routes["moe_ffn_ep"] == 0
    assert routes["moe_ffn"] == routes["moe_ffn_tp"] == len(BATCHES)
    _held_to_one_device(got, _one_device("moe", _moe(BATCHES)),
                        grad_steps=MOE_GRAD_STEPS)
    _same_on_all_ranks(world, "tp_step:moe_cap")


def _assemble(world, key, dims):
    """A moe_ep_tp leaf put together from the 4 ranks: rank (d, m)'s block
    at data block d along dims[0] and model block m along dims[1] (None:
    the same on those ranks, checked)."""
    dd, md = dims
    rows = []
    for d in (0, 1):
        blocks = [world[2 * d + m]["moe_ep_tp"] for m in (0, 1)]
        parts = [b["gp"][key] if key in b["gp"] else b[key] for b in blocks]
        if md is None:
            np.testing.assert_array_equal(parts[0], parts[1])
            rows.append(parts[0])
        else:
            rows.append(np.concatenate(parts, md))
    if dd is None:
        np.testing.assert_array_equal(rows[0], rows[1])
        return rows[0]
    return np.concatenate(rows, dd)


MOE_DIMS = {"out": (0, None), "gx": (0, None), "wi": (0, 2), "wg": (0, 2),
            "wo": (0, 1), "router": (None, None),
            "shared_wi": (None, None), "shared_wg": (None, None),
            "shared_wo": (None, None)}


def _emulated(payload, tp_shards):
    x = tensor_from_numpy(payload["x"], "cpu").bfloat16().requires_grad_(
        True)
    p = {k: tensor_from_numpy(v, "cpu").bfloat16().requires_grad_(True)
         for k, v in payload["params"].items()}
    out, aux = moe.moe_ffn_ep_emulated(x, p, n_experts=payload["n_experts"],
                                       k=payload["k"], n_shards=2,
                                       tp_shards=tp_shards)
    names = sorted(p)
    loss = (out.float() * torch.from_numpy(payload["cot"])).sum() \
        + payload["coef"] * aux
    g = torch.autograd.grad(loss, [x] + [p[k] for k in names])
    return {"out": out.detach().float().numpy(), "aux": float(aux.detach()),
            "gx": g[0].float().numpy(),
            "gp": {k: t.float().numpy() for k, t in zip(names, g[1:])}}


def test_moe_ffn_ep_has_tp_matches_jax_and_emulation(world, jax_ref):
    got = {k: _assemble(world, k, MOE_DIMS[k]) for k in ("out", "gx")}
    got["gp"] = {k: _assemble(world, k, v) for k, v in MOE_DIMS.items()
                 if k not in ("out", "gx")}
    aux = {world[r]["moe_ep_tp"]["aux"] for r in range(4)}
    assert len(aux) == 1
    got["aux"] = aux.pop()
    emu = _emulated(_moe_inputs(), tp_shards=2)
    # the world's function in one process, bit for bit: the d_ff blocks'
    # bf16 partials summed in f32 and rounded, as the 2 model ranks do
    np.testing.assert_array_equal(got["out"], emu["out"])
    assert got["aux"] == emu["aux"]
    np.testing.assert_array_equal(got["gx"], emu["gx"])
    for k in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(got["gp"][k], emu["gp"][k])
    _grads_close(got["gp"], emu["gp"])
    # and the has_tp branch is not the TP-free one
    assert not np.array_equal(got["out"],
                              _emulated(_moe_inputs(), 1)["out"])
    ref = jax_ref["moe_tp"]
    if "error" in ref:
        pytest.skip(f"the reference's moe_ffn_ep on a 2 x 2 mesh raises "
                    f"{ref['error']} on this jax: held to the emulation "
                    f"only")
    want = ref["ok"]
    scale = np.abs(want["out"]).max()
    assert np.abs(got["out"] - want["out"]).max() <= OUT_ULPS * scale
    assert abs(got["aux"] - want["aux"]) <= AUX_RTOL * abs(want["aux"])
    _grads_close({"gx": got["gx"], **got["gp"]},
                 {"gx": want["gx"], **want["gp"]})


# ------------------------------------------------------------------- (e)

# (g)'s families: the leaves a model axis of 2 must split, and the dim
# (hymba's in_proj in its packed layout; the odd vocabs' embed and head
# whole, checked below)
FAMILY_SPLITS = {
    "hybrid": {"layers/attn/wq": 2, "layers/attn/wk": 2,
               "layers/attn/wo": 1, "layers/ffn/wi": 2, "layers/ffn/wo": 1,
               "layers/mamba/in_proj": 2, "layers/mamba/conv_w": 2,
               "layers/mamba/x_proj": 1, "layers/mamba/dt_proj": 2,
               "layers/mamba/dt_bias": 1, "layers/mamba/a_log": 1,
               "layers/mamba/d": 1, "layers/mamba/out_proj": 1},
    "ssm": {"embed": 0, "head": 1, "layers/tm/wr": 2, "layers/tm/wg": 2,
            "layers/tm/u": 1, "layers/tm/wo": 1, "layers/cm/wk": 2,
            "layers/cm/wv": 1},
    "encdec": {"enc_layers/attn/wq": 2, "enc_layers/attn/wo": 1,
               "enc_layers/ffn/wi": 2, "enc_layers/ffn/bi": 1,
               "enc_layers/ffn/wo": 1, "dec_layers/xattn/wk": 2,
               "dec_layers/xattn/wo": 1, "dec_layers/ffn/wo": 1},
    "vlm": {"layers/attn/wq": 2, "layers/attn/wk": 2, "layers/attn/wo": 1,
            "layers/ffn/wi": 2, "layers/ffn/wo": 1},
}
FAMILY_WHOLE = {"hybrid": ("embed", "head", "layers/mamba/norm_ssm"),
                "ssm": ("layers/tm/ln_x", "layers/tm/td_a",
                        "layers/cm/wr"),
                "encdec": ("embed", "head", "enc_layers/ffn/bo",
                           "dec_pos"),
                "vlm": ("embed", "head")}


@pytest.mark.parametrize("name", ["tp_step:adamw", "tp_step:moe_ep"] + [
    f"tp_step:{f}" for f in FAMILIES])
def test_splits_happen_and_replicas_stay_equal(world, name):
    res = world[0][name]
    family = name.split(":")[1]
    whole = {k: v.shape for k, v in D._flat(res["params"]).items()}
    local = res["local_shapes"]
    if family in FAMILIES:
        half = FAMILY_SPLITS[family]
        for path in FAMILY_WHOLE[family]:
            assert tuple(local[path]) == tuple(whole[path]), path
            assert res["model_dims"][path] is None, path
    elif family == "moe_ep":
        half = {"layers/attn/wq": 2, "layers/attn/wo": 1, "embed": 0,
                "layers/moe/wi": 3, "layers/moe/wo": 2,
                "layers/moe/shared_wi": 2, "dense_layers/ffn/wo": 1}
    else:
        half = {"layers/attn/wq": 2, "layers/attn/wo": 1, "embed": 0,
                "layers/ffn/wi": 2, "layers/ffn/wo": 1, "layers/attn/wk": 2}
    for path, dim in half.items():
        want = list(whole[path])
        want[dim] //= 2
        if path == "layers/moe/wi" or path == "layers/moe/wo":
            want[1] //= 2            # the experts over "data" (EP)
        assert list(local[path]) == want, (path, local[path], whole[path])
        assert res["model_dims"][path] == dim
    # replicated leaves bit-equal across the model ranks, and every leaf
    # not split over "data" bit-equal across the data ranks, every step
    for i in range(len(res["steps"])):
        leaves = [world[r][name]["steps"][i]["leaves"] for r in range(4)]
        for path in leaves[0]:
            if res["model_dims"][path] is None:
                assert leaves[0][path] == leaves[1][path], path
                assert leaves[2][path] == leaves[3][path], path
            if res["data_dims"][path] is None:
                assert leaves[0][path] == leaves[2][path], path
                assert leaves[1][path] == leaves[3][path], path
    assert any(d is None for d in res["model_dims"].values())


# ------------------------------------------------------------------- (f)

def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_tp_checkpoint_restores_bit_equal(world):
    runs = [world[r]["tp_trainer"] for r in range(4)]
    assert all(r["restored_equal"] and r["step"] == 2 for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    step, state = CheckpointManager(world["dir"]).restore(device="cpu")
    assert step == 2
    whole = D._flat(state)
    for k, t in whole.items():
        np.testing.assert_array_equal(_bits(t).numpy(), runs[0]["whole"][k])
    # into TP 2's blocks: a {"model": 2} plan's block of each whole leaf is
    # the model rank's block of the 2 x 2 world (no leaf of the dense
    # model splits over "data")
    cfg = D._cfg(DENSE)
    specs = D._flat(_tp2_specs(cfg))
    split = 0
    for m in (0, 1):
        mesh = types.SimpleNamespace(shape={"model": 2}, coords={"model": m})
        for k, t in whole.items():
            want = sharding.local_shard(t, specs.get(k, ()), mesh)
            split += want.shape != t.shape
            np.testing.assert_array_equal(_bits(want).numpy(),
                                          runs[m]["local"][k])
    assert split > 0
    # one more step on one device from the restored state
    step_fn, _ = step_lib.build_train_step(build_model(cfg), **D.STEP_KW)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    _, _, m = step_fn(state["params"], state["opt"], batch)
    assert np.isfinite(float(m["loss"]))


def _tp2_specs(cfg):
    """The spec trees ({"params", "opt"}) of cfg's training plan over
    {"model": 2}, built on the abstract trees (no mesh needed)."""
    from repro_torch.optim.adafactor import make_optimizer
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, types.SimpleNamespace(
        shape={"model": 2}), kind="train")
    ab = model.abstract_params()
    ps = sharding.params_shardings(plan, model.param_axes, ab,
                                   model.param_parts)
    st = make_optimizer(cfg.optimizer, lambda s: s).init(ab)
    return {"params": ps, "opt": sharding.opt_state_specs(ps, st)}


# ------------------------------------------------------------------- (g)

@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_tp_step_matches_one_device_and_jax(world, family_ref,
                                                   family_params, name):
    """The family's TP step against the port's one-device step and the
    JAX package's unsharded step on the same weights and batches: losses
    within LOSS_ATOL, grad norms within GRAD_RTOL, step 0's grads leaf by
    leaf (FAMILY_GRAD_STEPS); every rank computed the same."""
    got = world[0][f"tp_step:{name}"]
    payload = _family(name, family_params[name])
    _held_to_one_device(got, _one_device(name, payload),
                        grad_steps=FAMILY_GRAD_STEPS)
    want = family_ref[name]
    np.testing.assert_allclose(_losses(got),
                               [m["loss"] for m in want["metrics"]],
                               atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(
        [s["metrics"]["grad_norm"] for s in got["steps"]],
        [m["grad_norm"] for m in want["metrics"]], rtol=GRAD_RTOL)
    jg = D._flat(D._to_numpy(params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), want["grads0"]),
        D._cfg(payload), device="cpu")))
    skip = JAX_BF16_SUMS.get(name, ())
    _grads_close({k: v for k, v in D._flat(got["steps"][0]["grads"]).items()
                  if k not in skip},
                 {k: v for k, v in jg.items() if k not in skip})
    _same_on_all_ranks(world, f"tp_step:{name}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_reference_tp_step_matches_the_port(world, family_ref, name):
    """The reference's own TP step over ("model", 2) (make_plan +
    build_train_step; it runs on this jax for all four families) against
    the port's TP step and the JAX unsharded step: losses within
    LOSS_ATOL, grad norms within GRAD_RTOL."""
    out = family_ref[name]["tp_step"]
    assert "ok" in out, out
    got = world[0][f"tp_step:{name}"]["steps"]
    for want in (out["ok"], family_ref[name]["metrics"]):
        np.testing.assert_allclose([s["metrics"]["loss"] for s in got],
                                   [m["loss"] for m in want],
                                   atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose([s["metrics"]["grad_norm"] for s in got],
                                   [m["grad_norm"] for m in want],
                                   rtol=GRAD_RTOL)


def test_hybrid_tp_checkpoint_keeps_the_packed_in_proj(world):
    """A hymba Trainer checkpoint of the 2 x 2 world: whole leaves (the
    packed in_proj put back as xs | z), restored bit for bit onto the
    world's ranks, onto one device (then one more step) and into TP 2's
    blocks, where a rank's in_proj is its block of xs beside its block of
    z, not the rank-major block."""
    runs = [world[r]["tp_trainer:hybrid"] for r in range(4)]
    assert all(r["restored_equal"] and r["step"] == 2 for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    step, state = CheckpointManager(world["dir_hybrid"]).restore(
        device="cpu")
    assert step == 2
    whole = D._flat(state)
    for k, t in whole.items():
        np.testing.assert_array_equal(_bits(t).numpy(), runs[0]["whole"][k])
    cfg = D._cfg(FAMILIES["hybrid"])
    specs = D._flat(_tp2_specs(cfg))
    packed = [k for k in specs if sharding.spec_parts(specs[k]) > 1]
    assert sorted(packed) == ["opt/m/layers/mamba/in_proj",
                              "opt/v/layers/mamba/in_proj",
                              "params/layers/mamba/in_proj"]
    for m in (0, 1):
        mesh = types.SimpleNamespace(shape={"model": 2}, coords={"model": m})
        for k, t in whole.items():
            want = sharding.local_shard(t, specs.get(k, ()), mesh)
            np.testing.assert_array_equal(_bits(want).numpy(),
                                          runs[m]["local"][k])
        # the rank-major block is another layout (rank 0's would be xs)
        k = "params/layers/mamba/in_proj"
        plain = sharding.local_shard(whole[k], tuple(specs[k]), mesh)
        assert not np.array_equal(_bits(plain).numpy(), runs[m]["local"][k])
    step_fn, _ = step_lib.build_train_step(build_model(cfg), **D.STEP_KW)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, vocab=127).items()}
    _, _, m = step_fn(state["params"], state["opt"], batch)
    assert np.isfinite(float(m["loss"]))


def test_hybrid_pallas_scan_raises_under_tp(world):
    """hymba with ssm_impl "pallas" over the model axis: the forward runs
    (its loss as "chunked"'s within LOSS_ATOL) and the backward raises the
    kernel's NotImplementedError on every rank, as on one device."""
    chunked = world[0]["tp_step:hybrid"]["steps"][0]["metrics"]["loss"]
    for r in range(4):
        cls, msg = world[r]["tp_pallas"]["raised"]
        assert cls == "NotImplementedError" and "no backward" in msg
    # a rank's loss is its data rank's share (ranks 0 and 2 hold model
    # rank 0 of data ranks 0 and 1)
    for m in (0, 1):
        shares = [world[2 * d + m]["tp_pallas"]["loss"] for d in (0, 1)]
        assert abs(sum(shares) - chunked) <= LOSS_ATOL


# ------------------------------------------------------------------- (h)

def _co_split(specs):
    """The leaves whose one dim the model axis and the data axes split
    together, model first."""
    return sorted(k for k, spec in specs.items()
                  if any(isinstance(e, tuple) and e[0] == "model"
                         and "data" in e for e in spec))


# step 0's metrics an FSDP x TP step gives bit-equal to the DP x TP step's
# (the same gathered bits in the forward; the one f32 addition of a
# 2-rank reduce-scatter commutes); the global grad norm is not among them:
# FSDP sums each split leaf's squares over its quarter blocks and then
# the data group, DP x TP over its half blocks, so the f32 sums round
# apart, by at most FSDP_GNORM_RTOL (measured below 2e-7)
BIT_EQUAL_METRICS = ("loss", "aux", "ntokens", "lr", "total_loss")
FSDP_GNORM_RTOL = 1e-6
OPT_RTOL = 1e-5


@pytest.mark.parametrize("name", list(FSDP_CASES))
def test_fsdp_tp_step_matches_dp_tp_and_one_device(world, jax_ref,
                                                   family_ref, jax_params,
                                                   family_params, name):
    """FSDP beside the model axis (fsdp=True over {"data": 2, "model": 2})
    against the DP x TP step of the same model on the same mesh: its plan
    co-splits at least one leaf (hymba's packed in_proj among them); step
    0's loss, metrics and every reduced grad leaf bit for bit, the grad
    norm within FSDP_GNORM_RTOL; every rank the same; the losses of both
    steps within LOSS_ATOL of the port's one-device step, and where the
    JAX subprocesses ran it, of the reference's own TP step."""
    got = world[0][f"tp_step:fsdp_{name}"]
    base = world[0][FSDP_CASES[name]]
    co = _co_split(got["specs"])
    assert co, got["specs"]
    assert not _co_split(base["specs"])
    if name == "hybrid":
        spec = got["specs"]["layers/mamba/in_proj"]
        assert "layers/mamba/in_proj" in co
        assert sharding.spec_parts(spec) == 2
    s0, b0 = got["steps"][0], base["steps"][0]
    for k in BIT_EQUAL_METRICS:
        assert s0["metrics"][k] == b0["metrics"][k], k
    g, b = s0["metrics"]["grad_norm"], b0["metrics"]["grad_norm"]
    assert abs(g - b) <= FSDP_GNORM_RTOL * b, (g, b)
    gf, bf = D._flat(s0["grads"]), D._flat(b0["grads"])
    assert sorted(gf) == sorted(bf)
    for k in gf:
        np.testing.assert_array_equal(gf[k], bf[k], err_msg=k)
    # the optimizer state after step 0, from the same grads: a split
    # leaf's sums (AdamW's clip; Adafactor's row and column means, each
    # over every group that splits the dim) counted once per group, so
    # within the f32 sums' order of DP x TP's, never a group twice
    of, ob = D._flat(s0["opt"]), D._flat(b0["opt"])
    assert sorted(of) == sorted(ob)
    for k in of:
        np.testing.assert_allclose(of[k], ob[k], rtol=OPT_RTOL, atol=0,
                                   err_msg=k)
    _same_on_all_ranks(world, f"tp_step:fsdp_{name}")
    ref = _one_device({"dense": "dense:adamw"}.get(name, name),
                      _fsdp_payload(name, jax_params, family_params))
    np.testing.assert_allclose(_losses(got), _losses(ref), atol=LOSS_ATOL,
                               rtol=0)
    jax_tp = (jax_ref["tp_step"] if name == "dense" else
              family_ref[name]["tp_step"] if name in FAMILIES else None)
    if jax_tp is not None:
        assert "ok" in jax_tp, jax_tp
        np.testing.assert_allclose(_losses(got),
                                   [m["loss"] for m in jax_tp["ok"]],
                                   atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["qwen25", "hybrid"])
def test_fsdp_tp_checkpoint_restores_everywhere(world, name):
    """A Trainer checkpoint of the FSDP x TP world (whole leaves, gathered
    over the data axes and then the model axis) restored bit for bit onto
    its ranks, onto one device (then one more step) and into TP 2's
    blocks, which are the world's blocks gathered over the data axes
    alone (hymba's in_proj in its packed layout)."""
    runs = [world[r][f"tp_trainer:fsdp_{name}"] for r in range(4)]
    assert all(r["restored_equal"] and r["step"] == 2 for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert _co_split(runs[0]["specs"])
    step, state = CheckpointManager(world["dir_fsdp"][name]).restore(
        device="cpu")
    assert step == 2
    whole = D._flat(state)
    for k, t in whole.items():
        np.testing.assert_array_equal(_bits(t).numpy(), runs[0]["whole"][k])
    cfg = D._cfg(QWEN25 if name == "qwen25" else FAMILIES["hybrid"])
    specs = D._flat(_tp2_specs(cfg))
    for m in (0, 1):
        mesh = types.SimpleNamespace(shape={"model": 2}, coords={"model": m})
        for k, t in whole.items():
            want = sharding.local_shard(t, specs.get(k, ()), mesh)
            for r in (m, 2 + m):          # the model rank's two data ranks
                np.testing.assert_array_equal(_bits(want).numpy(),
                                              runs[r]["tp_block"][k],
                                              err_msg=k)
    step_fn, _ = step_lib.build_train_step(build_model(cfg), **D.STEP_KW)
    vocab = cfg.vocab_size
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(4, vocab=vocab).items()}
    _, _, m = step_fn(state["params"], state["opt"], batch)
    assert np.isfinite(float(m["loss"]))


def test_tp_checkpoint_restores_into_fsdp_tp(world):
    """The dense TP world's checkpoint ((f)'s: the model axis alone)
    restored into FSDP x TP's blocks on the 4 ranks: each rank's block of
    every whole leaf (co-split leaves among them), and one step from it
    within LOSS_ATOL of the one-device step from the same checkpoint."""
    step, state = CheckpointManager(world["dir"]).restore(device="cpu")
    whole = D._flat(state)
    res = [world[r]["restore_step:tp_into_fsdp"] for r in range(4)]
    assert _co_split({k[len("params/"):]: v for k, v in
                      res[0]["specs"].items() if k.startswith("params/")})
    for r, out in enumerate(res):
        assert out["step"] == step == 2
        mesh = types.SimpleNamespace(shape=SHAPE, coords={
            "data": r // 2, "model": r % 2})
        for k, t in whole.items():
            want = sharding.local_shard(t, out["specs"].get(k, ()), mesh)
            np.testing.assert_array_equal(_bits(want).numpy(),
                                          out["local"][k], err_msg=k)
    assert len({o["metrics"]["loss"] for o in res}) == 1
    step_fn, _ = step_lib.build_train_step(build_model(D._cfg(DENSE)),
                                           **D.STEP_KW)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    _, _, m = step_fn(state["params"], state["opt"], batch)
    assert abs(res[0]["metrics"]["loss"] - float(m["loss"])) <= LOSS_ATOL
