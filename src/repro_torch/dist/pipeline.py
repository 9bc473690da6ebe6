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

Forward only: nothing in the reference trains through it, and the
exchanges here carry no gradient (ROADMAP queue 1: the pipeline's
gradient is still to port).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist.collectives import AxesGroup

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


@torch.no_grad()
def pipelined_apply(fn: Callable, stage_params: Tree, x: torch.Tensor, *,
                    mesh, pp_axis: str) -> torch.Tensor:
    """x (M, B, ...), M microbatches, through this rank's stage of a layer
    stack, pipelined over `pp_axis`.

    fn: (layer_params, h) -> h, one layer's apply.
    stage_params: this rank's stage: a tree whose leaves lead with its
        L / S layers.
    x: the whole (M, B, ...) stream, the same on every rank.

    Returns (M, B, ...) on every rank: each microbatch through all L
    layers in order (tests/test_torch_dist_train.py holds it to the
    dense scan and to the JAX package's pipelined_apply)."""
    group = AxesGroup(mesh, (pp_axis,))
    s_count, stage = group.size, group.index
    m_count = int(x.shape[0])
    n_local = _leading(stage_params)

    def run_stage(h):
        for i in range(n_local):
            h = fn(_layer(stage_params, i), h)
        return h

    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m_count + s_count - 1):
        if stage == 0:                   # stage 0 ingests microbatch t
            buf = x[min(t, m_count - 1)]
        y = run_stage(buf)
        m = t - (s_count - 1)            # the last stage finishes m
        if stage == s_count - 1 and m >= 0:
            outs[m] = y
        buf = group.ring_shift(y)        # to the next stage
    if stage != s_count - 1:
        outs.zero_()
    return group.all_reduce(outs)
