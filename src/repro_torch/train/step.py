"""The train step — the port of `repro.train.step.build_train_step`
(:110-196) for one device: model + optimizer -> step function.

    step_fn, opt = build_train_step(model, peak_lr=3e-4, total_steps=100)
    params, opt_state, metrics = step_fn(params, opt_state, batch)

The gradients are `torch.autograd.grad` of `model.loss_fn` over the param
leaves (which the step marks `requires_grad`); the optimizer then updates
params and its state in place (see optim/adamw.py). microbatches > 1
splits the batch along dim 0 as the JAX step does (microbatch i takes
rows i, i + n, i + 2n, ...) and accumulates f32 grads over a Python loop;
grad_compress="bf16" casts the grads to bf16 before the update. The mesh,
the training sharding plan (`make_plan`) and `StepBundle` wait for ROADMAP
queue 1, item 9.2.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch import backend
from repro_torch.models.registry import Model
from repro_torch.optim.adafactor import make_optimizer
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.schedule import linear_warmup_cosine


def build_train_step(model: Model, *, optimizer_name: str = None,
                     peak_lr: float = 3e-4, warmup: int = 2000,
                     total_steps: int = 100_000, grad_compress: str = "none",
                     microbatches: int = 1) -> Tuple[Callable, object]:
    """Returns (step_fn, optimizer); step_fn(params, opt_state, batch) ->
    (params, opt_state, metrics), batch {"tokens", "labels"} (B, S) int
    tensors on the params' device, metrics 0-d f32 tensors ("loss", "aux",
    "ntokens", "grad_norm", "lr", "total_loss")."""
    if grad_compress not in ("none", "bf16"):
        raise ValueError(f"grad_compress {grad_compress!r}: 'none' or 'bf16'")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    opt = make_optimizer(
        optimizer_name or model.cfg.optimizer,
        functools.partial(linear_warmup_cosine, peak_lr=peak_lr,
                          warmup=warmup, total=total_steps))

    def grad_fn(params, batch) -> Tuple[torch.Tensor, Dict, Dict]:
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves)
        return (total.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    @backend.f32_accumulation()
    def train_step(params, opt_state, batch):
        if microbatches > 1:
            n = microbatches
            if batch["tokens"].shape[0] % n:
                raise ValueError(f"batch {batch['tokens'].shape[0]} does "
                                 f"not split into {n} microbatches")
            grads, losses, ms = None, [], []
            for i in range(n):
                loss, metrics, g = grad_fn(
                    params, {k: v[i::n] for k, v in batch.items()})
                g = tree_map(lambda x: x.float() / n, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                losses.append(loss)
                ms.append(metrics)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            loss, metrics, grads = grad_fn(params, batch)
        if grad_compress == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state, opt_metrics = opt.update(params, grads, opt_state)
        return params, opt_state, {**metrics, **opt_metrics,
                                   "total_loss": loss}

    return train_step, opt
