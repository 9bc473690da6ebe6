"""Rank cases for tests/test_torch_tp_train.py: tensor-parallel training in
the port on one rank of a gloo world over a {"data": 2, "model": 2} mesh
(`_torch_tp_worker.run_world(..., shape={"data": 2, "model": 2},
module="_torch_tp_train_worker")`), and for tests/test_torch_fsdp_tp_pods.py
over {"pod": 2, "data": 2, "model": 2}. The one-device references run in the
test process (`_torch_dp_worker.dp_step` without a mesh, and
`emulated_ep` for the expert-parallel route). torch and repro_torch
only: no jax here."""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

import _torch_dp_worker as D


def _leaf_digests(tree):
    """{path: sha1 of the leaf's bytes}."""
    out = {}
    for k, t in D._flat(tree).items():
        out[k] = hashlib.sha1(t.detach().contiguous().reshape(-1)
                              .view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()
    return out


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _whole_of(plan, specs, bundle):
    """A function of a tree of this rank's blocks (params-shaped) that
    gathers it whole over the model axis and the data axes (a packed
    leaf's parts put back whole)."""
    from repro_torch.dist import sharding
    dims = sharding.data_dims(plan, specs)
    mdims = sharding.model_dims(plan, specs)

    def whole_of(tree):
        return sharding.gather_tree(tree, dims, bundle.group,
                                    model_dims=mdims,
                                    model_group=bundle.model_group,
                                    parts=sharding.packed_parts(specs))
    return whole_of


def tp_step(mesh, payload):
    """payload["batches"] (global numpy batches) through build_train_step
    under make_plan over `mesh` (the reference plan: row-parallel over
    "model", rows over "data"; with payload["fsdp"] FSDP beside it): each
    step's metrics, the whole grads the optimizer got and its state after
    the step (gathered over both axes), each local leaf's digest after the
    step, plus the whole params
    at the end, every leaf's local shape, spec and data / model dims, and
    the moe routes taken."""
    from repro_torch.dist import sharding
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import step as step_lib
    cfg = D._cfg(payload)
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train",
                              fsdp=payload.get("fsdp"))
    bundle, opt = step_lib.build_train_step(
        model, plan, optimizer_name=payload.get("optimizer"),
        microbatches=payload.get("microbatches", 1),
        grad_compress=payload.get("grad_compress", "none"), **D.STEP_KW)
    ps = bundle.in_specs[0]
    dev = D._device(mesh, payload)
    params = tree_map(lambda t: t.to(dev), sharding.shard_tree(
        D._whole_params(cfg, payload), ps, mesh))
    whole_of = _whole_of(plan, ps, bundle)
    opt_state = opt.init(params)
    seen = []
    real = opt.update

    def update(p, g, s, shards=None):
        seen.append(D._to_numpy(whole_of(g)))
        return real(p, g, s, shards)

    object.__setattr__(opt, "update", update)
    routes = {"moe_ffn_ep": 0, "moe_ffn_ep_tp": 0, "moe_ffn": 0,
              "moe_ffn_tp": 0}
    real_route = {k: getattr(moe, k) for k in ("moe_ffn_ep", "moe_ffn")}

    def counted(name):
        def call(*a, **kw):
            routes[name] += 1
            if kw.get("tp") is not None:
                routes[name + "_tp"] += 1
            return real_route[name](*a, **kw)
        return call

    os_ = bundle.in_specs[1]
    opt_whole = _whole_of(plan, os_, bundle)
    steps = []
    for k in real_route:
        setattr(moe, k, counted(k))
    try:
        for b in payload["batches"]:
            batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            batch = {k: v.to(dev) for k, v in
                     sharding.local_batch(plan, batch).items()}
            params, opt_state, m = bundle(params, opt_state, batch)
            steps.append({"metrics": {k: float(v) for k, v in m.items()},
                          "grads": seen[-1],
                          "opt": D._to_numpy(opt_whole(opt_state)),
                          "leaves": _leaf_digests(params)})
    finally:
        for k, f in real_route.items():
            setattr(moe, k, f)
    return {"steps": steps, "params": D._to_numpy(whole_of(params)),
            "local_shapes": {k: tuple(v.shape) for k, v in
                             D._flat(params).items()},
            "data_dims": D._flat(sharding.data_dims(plan, ps)),
            "model_dims": D._flat(sharding.model_dims(plan, ps)),
            "specs": D._flat(ps), "routes": routes}


@contextlib.contextmanager
def emulated_ep(n_shards: int, tp_shards: int):
    """While open, a one-device loss_fn's moe layers at EP_MIN_TOKENS
    tokens or more run moe_ffn_ep_emulated over `n_shards` data ranks and
    `tp_shards` model ranks (the rank world's expert-parallel route in one
    process; its aux, the sum of the ranks' shares, is the global one)."""
    from repro_torch.models import moe, registry
    real = registry._moe_apply

    def apply(cfg, lp, h, ctx=None, token_valid=None):
        b, s, d = h.shape
        if b * s < registry.EP_MIN_TOKENS or token_valid is not None:
            return real(cfg, lp, h, ctx, token_valid)
        f, aux = moe.moe_ffn_ep_emulated(
            h.reshape(-1, d), lp, n_experts=cfg.n_experts,
            k=cfg.experts_per_token, n_shards=n_shards, tp_shards=tp_shards)
        return f.reshape(b, s, d), aux

    registry._moe_apply = apply
    try:
        yield
    finally:
        registry._moe_apply = real


def moe_ep_tp(mesh, payload):
    """moe.moe_ffn_ep's has_tp branch on this rank's rows (over "data"),
    its experts (over "data") and their d_ff (over "model"; the shared
    experts whole, as the reference's moe_ffn_ep test lays them out): the
    output rows, the aux (summed over "data"), the grads of x (this
    rank's rows) and of every weight (this rank's blocks; the router's
    and the shared experts' summed over "data")."""
    from repro_torch.dist.collectives import AxesGroup
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models import moe
    x, cot, params = D._moe_inputs(payload, mesh, split_experts=True)
    specs = {"wi": (None, None, "model"), "wg": (None, None, "model"),
             "wo": (None, "model", None)}
    for k, spec in specs.items():
        params[k] = local_shard(params[k], spec, mesh).clone()
    x.requires_grad_(True)
    for p in params.values():
        p.requires_grad_(True)
    data, model = AxesGroup(mesh, ("data",)), AxesGroup(mesh, ("model",))
    out, aux = moe.moe_ffn_ep(x, params, n_experts=payload["n_experts"],
                              k=payload["k"], group=data, tp=model)
    names = sorted(params)
    loss = (out.float() * cot).sum() + payload["coef"] * aux
    grads = torch.autograd.grad(loss, [x] + [params[k] for k in names])
    gp = dict(zip(names, grads[1:]))
    # the replicated weights' grads: this data rank's tokens' part,
    # summed over "data"
    for k in ("router", "shared_wi", "shared_wg", "shared_wo"):
        gp[k] = data.all_reduce(gp[k])
    return {"out": out.detach().float().numpy(),
            "aux": float(data.all_reduce(aux.detach())),
            "gx": grads[0].float().numpy(),
            "gp": {k: g.float().numpy() for k, g in gp.items()}}


def tp_pallas(mesh, payload):
    """One TP step of payload's hybrid model with ssm_impl "pallas" under
    make_plan over `mesh`: the error its backward raises (class and
    message; None if it ran), and the forward loss alone (no grad)."""
    import dataclasses
    from repro_torch.dist import sharding
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    cfg = dataclasses.replace(D._cfg(payload), ssm_impl="pallas")
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train")
    bundle, opt = step_lib.build_train_step(model, plan, **D.STEP_KW)
    params = sharding.shard_tree(D._whole_params(cfg, payload),
                                 bundle.in_specs[0], mesh)
    batch = sharding.local_batch(plan, {
        k: torch.from_numpy(np.asarray(v))
        for k, v in payload["batches"][0].items()})
    with torch.no_grad():
        loss = float(model.loss_fn(params, batch,
                                   step_lib.make_dist_ctx(plan))[1]["loss"])
    try:
        bundle(params, opt.init(params), batch)
        raised = None
    except NotImplementedError as e:
        raised = (type(e).__name__, str(e))
    return {"raised": raised, "loss": loss}


def tp_trainer(mesh, payload):
    """Trainer(mesh=) for payload["steps"] steps (FSDP beside TP with
    payload["fsdp"]) with a checkpoint at the end (whole leaves, rank 0),
    then the checkpoint restored onto this rank under the same plan: its
    blocks against the live state, bit for bit, and the live state
    gathered whole and over the data axes alone (the model rank's block,
    TP's layout)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist import sharding
    from repro_torch.dist.fault import resume_or_init
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    cfg = D._cfg(payload)
    steps = payload["steps"]
    loop = TrainLoopConfig(total_steps=steps, ckpt_every=steps,
                           log_every=100, ckpt_dir=payload["dir"],
                           seq_len=32, global_batch=4, peak_lr=1e-3)
    tr = Trainer(cfg, loop, mesh, fsdp=payload.get("fsdp"))
    out = tr.run(verbose=mesh.rank == 0)
    specs = tr._specs()
    step, state = resume_or_init(CheckpointManager(payload["dir"]),
                                 lambda: None, device="cpu",
                                 shardings=specs, mesh=mesh)
    live, back = D._flat(tr.state), D._flat(state)
    same = sorted(live) == sorted(back) and all(
        torch.equal(_bits(live[k]), _bits(back[k])) for k in live)
    dims = sharding.data_dims(tr.plan, specs)
    whole = sharding.gather_tree(
        tr.state, dims, tr.bundle.group,
        model_dims=sharding.model_dims(tr.plan, specs),
        model_group=tr.bundle.model_group,
        parts=sharding.packed_parts(specs))
    tp_block = sharding.gather_tree(tr.state, dims, tr.bundle.group)
    return {"losses": out["losses"], "step": step, "restored_equal": same,
            "whole": D._to_numpy_exact(whole),
            "local": D._to_numpy_exact(tr.state),
            "tp_block": D._to_numpy_exact(tp_block), "specs": D._flat(specs)}


def restore_step(mesh, payload):
    """The checkpoint in payload["dir"] (whatever mesh wrote it) restored
    onto this rank under make_plan(fsdp=payload["fsdp"]), then one step of
    payload["batches"][0] from it: the restored blocks and the step's
    metrics."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist import sharding
    from repro_torch.dist.fault import resume_or_init
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    cfg = D._cfg(payload)
    plan = step_lib.make_plan(cfg, mesh, kind="train",
                              fsdp=payload.get("fsdp"))
    bundle, _ = step_lib.build_train_step(build_model(cfg), plan,
                                          **D.STEP_KW)
    specs = {"params": bundle.in_specs[0], "opt": bundle.in_specs[1]}
    step, state = resume_or_init(CheckpointManager(payload["dir"]),
                                 lambda: None, device="cpu",
                                 shardings=specs, mesh=mesh)
    # copies: the step updates the state in place
    local = {k: v.copy() for k, v in D._to_numpy_exact(state).items()}
    batch = sharding.local_batch(plan, {
        k: torch.from_numpy(np.asarray(v))
        for k, v in payload["batches"][0].items()})
    _, _, m = bundle(state["params"], state["opt"], batch)
    return {"step": step, "local": local, "specs": D._flat(specs),
            "metrics": {k: float(v) for k, v in m.items()}}


def pod_groups(mesh, payload):
    """AxesGroup over ("pod", "data") beside the model axis (the subgroup
    of this rank's model coordinate): its size, index and members, and
    all_reduce, all_gather and reduce_scatter of this rank's tensor
    (integer-valued f32 from the rank, so every sum is exact)."""
    import torch.distributed as dist
    from repro_torch.dist.collectives import AxesGroup
    group = AxesGroup(mesh, ("pod", "data"))
    t = rank_tensor(mesh.rank, payload["shape"])
    members = [dist.get_global_rank(group.group, i)
               for i in range(group.size)]
    return {"size": group.size, "index": group.index, "members": members,
            "all_reduce": group.all_reduce(t).numpy(),
            "all_gather": group.all_gather(t, 1).numpy(),
            "reduce_scatter": group.reduce_scatter(t, 0).numpy(),
            "counts": group.counts}


def rank_tensor(rank, shape):
    """pod_groups' input on `rank`: integer-valued f32."""
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randint(-50, 50, tuple(shape), generator=g).float()


# intra-op threads a rank: the world's 4 processes at torch's default (every
# core each) oversubscribe the cores and ran the 4096-token moe case ~10x
# slower; set in the rank processes only (the test process keeps its own)
RANK_THREADS = 2


def _in_rank(case):
    def run(mesh, payload):
        torch.set_num_threads(payload.get("threads", RANK_THREADS))
        return case(mesh, payload)
    return run


CASES = {name: _in_rank(case) for name, case in (
    ("tp_step", tp_step), ("moe_ep_tp", moe_ep_tp), ("tp_trainer", tp_trainer),
    ("tp_pallas", tp_pallas), ("restore_step", restore_step),
    ("pod_groups", pod_groups))}
