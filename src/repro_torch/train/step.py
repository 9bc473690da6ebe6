"""Train / serve step builders — the port of `repro.train.step`
(:32-225): model + optimizer + sharding plan -> step functions with their
spec trees.

    bundle, opt = build_train_step(model, plan, peak_lr=3e-4)
    params, opt_state, metrics = bundle(params, opt_state, batch)

The gradients are `torch.autograd.grad` of `model.loss_fn` over the param
leaves (which the step marks `requires_grad`); the optimizer then updates
params and its state in place (see optim/adamw.py). microbatches > 1
splits the batch along dim 0 as the JAX step does (microbatch i takes
rows i, i + n, i + 2n, ...) and accumulates f32 grads over a Python loop;
grad_compress="bf16" casts the grads to bf16 before the update.

With a plan (`make_plan`) the step runs on one rank of explicit SPMD
over the plan's data axes and its model axis: params and optimizer state
are this rank's blocks under the bundle's spec trees (the reference
plan's: under a model axis larger than 1, row-parallel wo and a
vocab-split embedding, never the serve plan's column-only specs), the
batch is this rank's rows (`sharding.local_batch`; the ranks of a model
group hold the same rows), and the step computes the reference's
function of the GLOBAL batch:

  * `loss_fn(params, batch, ctx)` gives this rank's share: its rows' sum
    over labels >= 0 divided by the global count (all-reduced first);
  * FSDP leaves (split over the data axes on any dim but an expert dim)
    are gathered over the data group before the forward, and their grads
    reduce-scattered back over it along the same dim; whole leaves' grads
    are all-reduced; EP leaves (experts split by `ep_data`) get their
    whole grads locally, through the moe route's exchanges. Beside a
    model axis the data gather gives the model rank's block (whole over
    the data axes), also where one dim is split over the model axis and
    the data axes together (`('model', 'data')`, model-major: the data
    axes cut the model rank's block), so the forward runs the TP step as
    it is, and a model-split leaf's grad is reduce-scattered over the
    data group only;
  * the sums run in f32 and the result takes the dtype the one-device
    step gives (the param's; f32 accumulators with microbatches);
    grad_compress="bf16" casts before the reduction, which is its point
    (half the bytes on the wire);
  * the metrics are all-reduced over the data axes, and the optimizer
    sums what it needs of a split leaf over each group that splits it
    (optim.adamw.Shards);
  * tensor parallelism (every family): the forward's row-parallel
    partial sums and the backward's input-grad sums run inside the model
    (layers.DistCtx, dist.collectives.CopyToGroup / ReduceFromGroup), so
    a model-split leaf's grad is this rank's block of the whole grad (a
    packed leaf's in its packed layout, sharding.PackedSpec) and a
    replicated leaf's is the whole grad on every rank of the model group:
    neither is reduced over the model axis here. The model ranks compute
    the same loss and metrics.

Every rank applies the same reduced grads in the same order, so the
replicas stay bit-equal. There is no `lower`: XLA lowering has no
counterpart. The dry-run (launch/dryrun.py) builds these steps over an
abstract mesh and counts a rank's call instead
(analyze.census.census_step).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import DATA_AXES
from repro_torch.models.layers import DistCtx
from repro_torch.models.registry import Model
from repro_torch.optim.adafactor import make_optimizer
from repro_torch.optim.adamw import (Shards, tree_leaves, tree_map,
                                    tree_unflatten)
from repro_torch.optim.schedule import linear_warmup_cosine

PyTree = Any


@dataclasses.dataclass
class StepBundle:
    """A step function with its layout: `in_specs` and `out_specs` (spec
    trees, dist/sharding.py; None where an argument is whole on every
    rank or not known ahead), the abstract arguments (trees on the "meta"
    device, whole shapes) and `donate_argnums` (the arguments the step
    updates in place). Calling the bundle calls `fn`. `kind` is "train",
    "prefill" or "decode". A step over a plan also carries its data group
    (`group`, whose `counts` are the step's collectives over the data
    axes) and its model group (`model_group`, the same over the model
    axis)."""
    fn: Callable
    in_specs: Tuple
    out_specs: Any
    abstract_args: Tuple
    donate_argnums: Tuple[int, ...] = ()
    plan: Optional[shd.ShardingPlan] = None
    group: Any = None
    model_group: Any = None
    kind: str = "train"

    def __call__(self, *args):
        return self.fn(*args)


def make_plan(cfg: ModelConfig, mesh, *, kind: str,
              fsdp: Optional[bool] = None,
              kv_seq_shard: Optional[bool] = None,
              ep_data: Optional[bool] = None) -> shd.ShardingPlan:
    """The reference's default sharding policy per arch size and cell kind
    (overridable): moe experts split over the data axes (EP) instead of
    FSDP; dense models above 8e9 params take FSDP in training; decode on
    attention families splits the cache's seq dim over the model axis."""
    dp_axes = tuple(a for a in DATA_AXES if a in mesh.shape)
    if ep_data is None:
        ep_data = cfg.family == "moe"
    if fsdp is None:
        big = cfg.param_count() > 8e9
        fsdp = big and kind == "train" and not ep_data
    if kv_seq_shard is None:
        kv_seq_shard = kind == "decode" and cfg.family in (
            "dense", "moe", "vlm", "encdec")
    return shd.ShardingPlan(mesh=mesh, dp_axes=dp_axes, fsdp=fsdp,
                            kv_seq_shard=kv_seq_shard, ep_data=ep_data)


def make_dist_ctx(plan: shd.ShardingPlan) -> DistCtx:
    return DistCtx(mesh=plan.mesh, data_axes=plan.dp_axes,
                   model_axis=plan.tp_axis or "model",
                   kv_seq_shard=plan.kv_seq_shard, ep_data=plan.ep_data)


def _param_specs(model: Model, plan: Optional[shd.ShardingPlan]):
    ab = model.abstract_params()
    if plan is None:
        return ab, None
    return ab, shd.params_shardings(plan, model.param_axes, ab,
                                    model.param_parts)


def _leaf_kinds(model: Model, plan, specs, dims):
    """Per param leaf: "whole" (every data rank holds it), "fsdp" (split,
    gathered for the forward) or "ep" (its experts dim split: used as the
    local block)."""

    def walk(spec, dim, path):
        if isinstance(spec, dict):
            return {k: walk(spec[k], dim[k], f"{path}/{k}" if path else k)
                    for k in spec}
        if dim is None:
            return "whole"
        axes = model.param_axes.get(path) or ()
        if plan.ep_data and dim < len(axes) and axes[dim] == "experts":
            return "ep"
        return "fsdp"

    return walk(specs, dims, "")


def build_train_step(model: Model, plan: Optional[shd.ShardingPlan] = None,
                     *, optimizer_name: Optional[str] = None,
                     peak_lr: float = 3e-4, warmup: int = 2000,
                     total_steps: int = 100_000, grad_compress: str = "none",
                     microbatches: int = 1) -> Tuple[StepBundle, object]:
    """Returns (bundle, optimizer); bundle(params, opt_state, batch) ->
    (params, opt_state, metrics), batch {"tokens", "labels"} (B, S) int
    tensors on the params' device (this rank's rows under a plan), metrics
    0-d f32 tensors ("loss", "aux", "ntokens", "grad_norm", "lr",
    "total_loss"), the global batch's on every rank."""
    if grad_compress not in ("none", "bf16"):
        raise ValueError(f"grad_compress {grad_compress!r}: 'none' or 'bf16'")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    opt = make_optimizer(
        optimizer_name or model.cfg.optimizer,
        functools.partial(linear_warmup_cosine, peak_lr=peak_lr,
                          warmup=warmup, total=total_steps))
    ab_params, ps = _param_specs(model, plan)
    ab_opt = opt.init(ab_params)
    ctx = group = mgroup = kinds = shards = None
    os_ = None
    if plan is not None:
        # the plan's splits first, before any group is made
        os_ = shd.opt_state_specs(ps, ab_opt)
        dims, mdims = shd.data_dims(plan, ps), shd.model_dims(plan, ps)
        kinds = _leaf_kinds(model, plan, ps, dims)
        ctx = make_dist_ctx(plan)
        group, mgroup = ctx.data_group(), ctx.model_group()
        if group.size > 1 or mgroup.size > 1:
            shards = Shards(dims=dims, group=group,
                            model_dims=mdims if mgroup.size > 1 else None,
                            model_group=mgroup)
    # the one-device step calls update(params, grads, state) as before
    update_kw = {} if shards is None else {"shards": shards}

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if ctx is None:
            total, metrics = model.loss_fn(params, batch)
        else:
            total, metrics = model.loss_fn(params, batch, ctx)
        grads = torch.autograd.grad(total, leaves)
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def gather_fsdp(params):
        """The params the forward sees: FSDP leaves gathered over the data
        group in sorted-key order (whole, or beside a model axis the model
        rank's block), the rest as they are."""
        if shards is None or "fsdp" not in tree_leaves(kinds):
            return params
        return tree_map(lambda p, k, d: group.all_gather(p, d)
                        if k == "fsdp" else p, params, kinds, shards.dims)

    def reduce_grads(grads):
        """A rank's grads summed over the data group (see the module
        docstring), leaf by leaf in sorted-key order on every rank, in
        f32 (bf16 with grad_compress), back in each grad's dtype."""
        wire = torch.bfloat16 if grad_compress == "bf16" else torch.float32
        out = []
        for g, kind, dim in zip(tree_leaves(grads), tree_leaves(kinds),
                                tree_leaves(shards.dims)):
            w = g.to(wire)
            if kind == "whole":
                w = group.all_reduce(w)
            elif kind == "fsdp":
                w = group.reduce_scatter(w, dim)
            out.append(w.to(g.dtype))
        return tree_unflatten(grads, out)

    @backend.f32_accumulation()
    def train_step(params, opt_state, batch):
        compute = gather_fsdp(params)
        if microbatches > 1:
            n = microbatches
            if batch["tokens"].shape[0] % n:
                raise ValueError(f"batch {batch['tokens'].shape[0]} does "
                                 f"not split into {n} microbatches")
            grads, losses, ms = None, [], []
            for i in range(n):
                loss, metrics, g = grad_fn(
                    compute, {k: v[i::n] for k, v in batch.items()})
                g = tree_map(lambda x: x.float() / n, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                losses.append(loss)
                ms.append(metrics)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            loss, metrics, grads = grad_fn(compute, batch)
        del compute
        if grad_compress == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        if group is not None and group.size > 1:
            grads = reduce_grads(grads)
            names = ("loss", "aux")
            summed = group.all_reduce(torch.stack(
                [metrics[k] for k in names] + [loss]))
            metrics = {**metrics, **dict(zip(names, summed[:2]))}
            loss = summed[2]
        params, opt_state, opt_metrics = opt.update(params, grads, opt_state,
                                                    **update_kw)
        return params, opt_state, {**metrics, **opt_metrics,
                                   "total_loss": loss}

    bundle = StepBundle(fn=train_step, in_specs=(ps, os_, None),
                        out_specs=(ps, os_, None),
                        abstract_args=(ab_params, ab_opt, None),
                        donate_argnums=(0, 1), plan=plan, group=group,
                        model_group=mgroup)
    return bundle, opt


def build_prefill_step(model: Model, plan: shd.ShardingPlan) -> StepBundle:
    """prefill_step(params, batch) -> model.prefill(params, batch, ctx)."""
    ctx = make_dist_ctx(plan)

    def prefill_step(params, batch):
        return model.prefill(params, batch, ctx)

    ab_params, ps = _param_specs(model, plan)
    return StepBundle(fn=prefill_step, in_specs=(ps, None), out_specs=None,
                      abstract_args=(ab_params, None), plan=plan,
                      group=ctx.data_group(), model_group=ctx.model_group(),
                      kind="prefill")


def build_decode_step(model: Model, plan: shd.ShardingPlan,
                      abstract_cache) -> StepBundle:
    """decode_step(params, cache, tokens) -> model.decode_step(params,
    cache, tokens, ctx); the cache is updated in place (donated)."""
    ctx = make_dist_ctx(plan)

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens, ctx)

    ab_params, ps = _param_specs(model, plan)
    cs = shd.cache_shardings(plan, model.cache_axes(), abstract_cache)
    return StepBundle(fn=decode_step, in_specs=(ps, cs, None),
                      out_specs=(None, cs),
                      abstract_args=(ab_params, abstract_cache, None),
                      donate_argnums=(1,), plan=plan,
                      group=ctx.data_group(), model_group=ctx.model_group(),
                      kind="decode")
