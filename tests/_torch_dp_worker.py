"""Rank cases for tests/test_torch_dist_train.py: data-parallel training
in the port on one rank of a gloo world over a {"data": n} mesh
(`_torch_tp_worker.run_world(..., shape={"data": n},
module="_torch_dp_worker")`). Each case also runs without a mesh in the
test process where that is the one-device reference. The tensors live
on the mesh's device (payload["device"] without a mesh; the CPU by
default). torch and repro_torch only: no jax here."""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

STEP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=10)


def _cfg(payload):
    import dataclasses
    from repro_torch.configs.base import get_config, reduce_config
    return dataclasses.replace(
        reduce_config(get_config(payload["arch"]), **payload["reduce"]),
        **payload.get("replace", {}))


def _whole_params(cfg, payload):
    """The whole params: the given numpy tree (JAX's weights) or the
    port's init from payload["seed"], on the CPU."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.registry import build_model
    if payload.get("params") is not None:
        return params_from_numpy(payload["params"], cfg, device="cpu")
    return build_model(cfg).init_params(payload["seed"], device="cpu")


def _device(mesh, payload):
    return mesh.device if mesh is not None else torch.device(
        payload.get("device", "cpu"))


def _digest(tree) -> str:
    from repro_torch.optim.adamw import tree_leaves
    h = hashlib.sha1()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def dp_step(mesh, payload):
    """payload["batches"] (global numpy batches) through build_train_step
    (over `mesh`'s data axes under make_plan(fsdp=payload["fsdp"]), or on
    one device): each step's metrics, the whole grads the optimizer got
    and a digest of the whole params after the step (gathered over the
    data axes), plus the whole params at the end."""
    from repro_torch.dist import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import step as step_lib
    cfg = _cfg(payload)
    model = build_model(cfg)
    plan = None if mesh is None else step_lib.make_plan(
        cfg, mesh, kind="train", fsdp=payload.get("fsdp", False))
    bundle, opt = step_lib.build_train_step(
        model, plan, optimizer_name=payload.get("optimizer"),
        microbatches=payload.get("microbatches", 1),
        grad_compress=payload.get("grad_compress", "none"), **STEP_KW)
    dev = _device(mesh, payload)
    whole = _whole_params(cfg, payload)
    if plan is None:
        params = tree_map(lambda t: t.to(dev), whole)

        def whole_of(tree):
            return tree
    else:
        ps = bundle.in_specs[0]
        params = tree_map(lambda t: t.to(dev),
                          sharding.shard_tree(whole, ps, mesh))
        group = step_lib.make_dist_ctx(plan).data_group()
        dims = sharding.data_dims(plan, ps)

        def whole_of(tree):
            return sharding.gather_tree(tree, dims, group)
    opt_state = opt.init(params)
    seen = []
    real = opt.update

    def update(p, g, s, shards=None):
        seen.append(_to_numpy(whole_of(g)))
        return real(p, g, s, shards)

    object.__setattr__(opt, "update", update)
    steps = []
    for b in payload["batches"]:
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        if plan is not None:
            batch = sharding.local_batch(plan, batch)
        batch = {k: v.to(dev) for k, v in batch.items()}
        params, opt_state, m = bundle(params, opt_state, batch)
        steps.append({"metrics": {k: float(v) for k, v in m.items()},
                      "grads": seen[-1],
                      "digest": _digest(whole_of(params)),
                      "local_digest": _digest(params)})
    return {"steps": steps, "params": _to_numpy(whole_of(params)),
            "local_shapes": {k: tuple(v.shape) for k, v in
                             _flat(params).items()}}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _moe_inputs(payload, mesh, *, split_experts: bool):
    """x, cot and the layer's params as this rank's tensors: x/cot rows
    rank-major, the experts split over "data" where asked (payload
    "as_bf16": x and the params arrive as f32 arrays of bf16 values)."""
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models.convert import tensor_from_numpy

    def t(a):
        return tensor_from_numpy(a, _device(mesh, payload))

    x, cot = t(payload["x"]), t(payload["cot"])
    params = {k: t(v) for k, v in payload["params"].items()}
    if payload.get("as_bf16"):          # f32 arrays holding bf16 values
        x = x.bfloat16()
        params = {k: v.bfloat16() for k, v in params.items()}
    if mesh is not None:
        x = local_shard(x, ("data",), mesh).clone()
        cot = local_shard(cot, ("data",), mesh).clone()
        if split_experts:
            for k in ("wi", "wg", "wo"):
                params[k] = local_shard(params[k], ("data",), mesh).clone()
    return x, cot, params


def _moe_grads(mesh, x, cot, params, out, aux, coef):
    """Grads of sum(out * cot) + coef * aux over x and the params; the
    replicated leaves' grads (router, shared experts and, unsplit, the
    experts) summed over the ranks."""
    from repro_torch.dist.collectives import AxesGroup
    names = sorted(params)
    loss = (out.float() * cot).sum() + coef * aux
    grads = torch.autograd.grad(loss, [x] + [params[k] for k in names])
    group = AxesGroup(mesh, ("data",))
    aux_all = group.all_reduce(aux.detach())
    gx, gp = grads[0], dict(zip(names, grads[1:]))
    return {"out": out.detach().float().cpu().numpy(),
            "aux": float(aux_all), "gx": gx.float().cpu().numpy(),
            "gp": {k: g.float().cpu().numpy() for k, g in gp.items()}}


def moe_ep(mesh, payload):
    """moe.moe_ffn_ep on this rank's rows and expert block."""
    from repro_torch.dist.collectives import AxesGroup
    from repro_torch.models import moe
    x, cot, params = _moe_inputs(payload, mesh, split_experts=True)
    x.requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    out, aux = moe.moe_ffn_ep(x, params, n_experts=payload["n_experts"],
                              k=payload["k"],
                              group=AxesGroup(mesh, ("data",)))
    res = _moe_grads(mesh, x, cot, params, out, aux, payload["coef"])
    for k in ("router", "shared_wi", "shared_wg", "shared_wo"):
        if k in res["gp"]:
            res["gp"][k] = AxesGroup(mesh, ("data",)).all_reduce(
                torch.from_numpy(res["gp"][k])).numpy()
    return res


def moe_capacity(mesh, payload):
    """registry._moe_apply's global capacity route on this rank's rows
    (B_l, S, D), with the experts whole or (ep) split over "data"."""
    from repro_torch.dist.collectives import AxesGroup
    from repro_torch.models.layers import DistCtx
    from repro_torch.models.registry import _moe_apply
    cfg = _cfg(payload)
    ep = payload.get("ep", False)
    x, cot, params = _moe_inputs(payload, mesh, split_experts=ep)
    x.requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    ctx = DistCtx(mesh=mesh, ep_data=ep)
    s = payload["seq"]
    h = x.reshape(-1, s, x.shape[-1])
    f, aux = _moe_apply(cfg, params, h, ctx)
    res = _moe_grads(mesh, x, cot, params, f.reshape(x.shape), aux,
                     payload["coef"])
    group = AxesGroup(mesh, ("data",))
    for k in res["gp"]:
        if not (ep and k in ("wi", "wg", "wo")):
            res["gp"][k] = group.all_reduce(
                torch.from_numpy(res["gp"][k])).numpy()
    return res


def int8(mesh, payload):
    """optim.compress.allreduce_int8 of this rank's grads."""
    from repro_torch.dist.collectives import AxesGroup
    from repro_torch.optim.compress import allreduce_int8, init_residual
    g = {"w": torch.from_numpy(payload["g"][mesh.rank]).to(mesh.device)}
    res = init_residual(g)
    out, new_res = allreduce_int8(g, res, AxesGroup(mesh, ("data",)))
    return {"out": out["w"].cpu().numpy(), "res": new_res["w"].cpu().numpy()}


def pipeline(mesh, payload):
    """dist.pipeline.pipelined_apply of tanh(h @ w) layers over the data
    axis, this rank's stage cut from the whole stack: the outputs, and the
    grads of sum(out * cot) with respect to the stage and the stream."""
    from repro_torch.dist.pipeline import pipelined_apply
    from repro_torch.dist.sharding import local_shard
    w = torch.from_numpy(payload["w"]).to(mesh.device)
    stage = local_shard(w, ("data",), mesh).clone().requires_grad_(True)
    x = torch.from_numpy(payload["x"]).to(mesh.device).requires_grad_(True)
    out = pipelined_apply(lambda p, h: torch.tanh(h @ p), stage, x,
                          mesh=mesh, pp_axis="data")
    cot = torch.from_numpy(payload["cot"]).to(mesh.device)
    gw, gx = torch.autograd.grad((out * cot).sum(), [stage, x])
    return {"out": out.detach().cpu().numpy(), "gw": gw.cpu().numpy(),
            "gx": gx.cpu().numpy()}


def elastic_in(mesh, payload):
    """A checkpoint written on one device restored onto this rank (FSDP
    specs): every restored leaf."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist.fault import resume_or_init
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    cfg = _cfg(payload)
    plan = step_lib.make_plan(cfg, mesh, kind="train", fsdp=True)
    bundle, _ = step_lib.build_train_step(build_model(cfg), plan, **STEP_KW)
    specs = {"params": bundle.in_specs[0], "opt": bundle.in_specs[1]}
    step, state = resume_or_init(CheckpointManager(payload["dir"]),
                                 lambda: None, device="cpu",
                                 shardings=specs, mesh=mesh)
    return {"step": step, "state": _flat(state), "specs": _flat(specs)}


def trainer(mesh, payload):
    """Trainer(mesh=) for payload["steps"] steps (each entry a run that
    resumes from the last), then its state gathered whole."""
    from repro_torch.dist import sharding
    from repro_torch.train import step as step_lib
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    cfg = _cfg(payload)
    runs, tr = [], None
    for total in payload["steps"]:
        loop = TrainLoopConfig(total_steps=total, log_every=100,
                               ckpt_dir=payload["dir"], seq_len=32,
                               global_batch=4, peak_lr=1e-3,
                               ckpt_every=payload.get("ckpt_every", total),
                               **payload.get("loop", {}))
        tr = Trainer(cfg, loop, mesh, fsdp=payload.get("fsdp"))
        out = tr.run(verbose=mesh.rank == 0)
        runs.append({"start": out["start_step"], "losses": out["losses"]})
    group = step_lib.make_dist_ctx(tr.plan).data_group()
    dims = sharding.data_dims(tr.plan, tr._specs())
    whole = sharding.gather_tree(tr.state, dims, group)
    return {"runs": runs, "state": _to_numpy_exact(whole)}


def _to_numpy_exact(tree) -> Dict:
    """Leaves as numpy bit patterns (bf16 as uint16), flattened."""
    out = {}
    for k, t in _flat(tree).items():
        t = t.detach()
        out[k] = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                  else t.numpy())
    return out


def serve_steps(mesh, payload):
    """build_prefill_step and build_decode_step under the prefill and
    decode plans over the data axes (or on one device without a mesh):
    the last-token logits of payload["tokens"] (this rank's rows), then
    of one decode step from an empty cache."""
    from repro_torch.dist import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    cfg = _cfg(payload)
    model = build_model(cfg)
    params = _whole_params(cfg, payload)
    tokens = torch.from_numpy(payload["tokens"])
    if mesh is None:
        plan = step_lib.make_plan(cfg, _OneRank(), kind="prefill")
        plan_d = step_lib.make_plan(cfg, _OneRank(), kind="decode")
    else:
        plan = step_lib.make_plan(cfg, mesh, kind="prefill")
        plan_d = step_lib.make_plan(cfg, mesh, kind="decode")
        tokens = sharding.local_batch(plan, {"t": tokens})["t"]
    logits, _ = step_lib.build_prefill_step(model, plan)(
        params, {"tokens": tokens})
    rows, clen = tokens.shape[0], payload["cache_len"]
    cache = model.init_cache(rows, clen, device="cpu")
    bundle = step_lib.build_decode_step(
        model, plan_d, model.init_cache(rows, clen, abstract=True))
    dec, _ = bundle(params, cache, tokens[:, :1])
    return {"prefill": logits.float().numpy(), "decode": dec.float().numpy(),
            "cache_specs": _flat(bundle.in_specs[1])}


class _OneRank:
    """A mesh of one rank for the plans (no process group)."""
    shape = {"data": 1}
    coords = {"data": 0}
    size = 1
    backend = "gloo"


CASES = {"dp_step": dp_step, "serve_steps": serve_steps, "moe_ep": moe_ep, "moe_capacity": moe_capacity,
         "int8": int8, "pipeline": pipeline, "elastic_in": elastic_in,
         "trainer": trainer}
