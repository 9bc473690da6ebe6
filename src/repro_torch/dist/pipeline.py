"""Pipeline parallelism: the GPipe schedule over the ranks of one mesh
axis — the port of `repro.dist.pipeline` (:31-99).

The layer stack (leading `layers` dim L) is split into S contiguous
stages, one a rank along the pipeline axis: stage s holds layers
[s L/S, (s + 1) L/S) (`sharding.local_shard` with the axis on dim 0).
Microbatches enter stage 0 one a tick and flow stage to stage around the
ring (`AxesGroup.ring_shift`: send / recv, the reference's ppermute);
after M + S - 1 ticks every microbatch has crossed every layer. As in
the reference, every stage computes every tick (fill and drain compute
on values the schedule masks off), the (M, B, ...) stream is replicated
on every stage, and a final all-reduce copies the last stage's outputs
to every rank. `bubble_fraction` is the schedule's idle share.

The schedule carries a gradient, that of the dense layer loop: the ring
shift is `RingShift` (its backward sends each grad back to the stage it
came from), the final all-reduce `ReduceFromGroup` (every rank computes
the same loss of the outputs, and the last stage's outputs take its
grad once), and the input stream enters through `CopyToGroup` (only
stage 0 reads it; every rank gets its whole grad). Every stage uses
every shift's result, the ones it ignores through a select, so each
rank runs every backward exchange in the same order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist.collectives import (AxesGroup, RingShift, copy_to,
                                          reduce_from)

Tree = Any


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1) of the M+S-1 ticks each
    device spends filling and draining."""
    s, m = n_stages, n_microbatches
    return (s - 1) / (m + s - 1)


def _leading(tree) -> int:
    if isinstance(tree, dict):
        return _leading(next(iter(tree.values())))
    return int(tree.shape[0])


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def pipelined_apply(fn: Callable, stage_params: Tree, x: torch.Tensor, *,
                    mesh, pp_axis: str) -> torch.Tensor:
    """x (M, B, ...), M microbatches, through this rank's stage of a layer
    stack, pipelined over `pp_axis`.

    fn: (layer_params, h) -> h, one layer's apply.
    stage_params: this rank's stage: a tree whose leaves lead with its
        L / S layers.
    x: the whole (M, B, ...) stream, the same on every rank.

    Returns (M, B, ...) on every rank: each microbatch through all L
    layers in order, and its gradient: with every rank taking the same
    loss of the result, a stage's params get their grads of it and x
    its whole grad on every rank (tests/test_torch_dist_train.py holds
    both to the dense scan, the outputs to the JAX package's
    pipelined_apply too)."""
    group = AxesGroup(mesh, (pp_axis,))
    s_count, stage = group.size, group.index
    m_count = int(x.shape[0])
    n_local = _leading(stage_params)
    ticks = m_count + s_count - 1
    x = copy_to(x, group)

    def run_stage(h):
        for i in range(n_local):
            h = fn(_layer(stage_params, i), h)
        return h

    def on(cond: bool) -> torch.Tensor:
        return torch.tensor(cond, device=x.device)

    buf = torch.zeros_like(x[0])
    ys = []
    for t in range(ticks):
        # stage 0 ingests microbatch t; a select, so the shifted buf it
        # ignores still takes part in the backward's exchanges
        buf = torch.where(on(stage == 0), x[min(t, m_count - 1)], buf)
        ys.append(run_stage(buf))
        if t < ticks - 1:
            buf = RingShift.apply(ys[-1], group) if s_count > 1 else ys[-1]
    # the last stage finishes microbatch t - S + 1 at tick t; the other
    # stages' values enter as zeros (and their grads as zeros), so every
    # rank's backward reaches its last tick
    out = torch.where(on(stage == s_count - 1),
                      torch.stack(ys[s_count - 1:]), 0.0)
    return reduce_from(out, group)
