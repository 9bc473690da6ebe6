"""AdamW on dicts of tensors — the port of `repro.optim.adamw`.

State: {"m": tree f32, "v": tree f32, "step": int32 0-d tensor}, m and v
shaped as the params. The update follows the JAX arithmetic in f32 (the
grads clipped by their global norm first, the bias corrections from the
f32 step) and casts the new params back to their dtype.

Unlike the JAX `update`, which returns new trees, the port updates the
params, m and v IN PLACE under `torch.no_grad()` and returns the same
dicts (with a new "step" tensor): at full width the optimizer state is
four times the bf16 params, and a second copy of it would not fit beside
the activations. Callers that need the old values clone them first.

Sharded (FSDP, EP, TP) training hands `update` a `Shards`: the leaves a
rank holds only a block of, and the groups over which to sum (the data
axes' and the model axis's; an EP expert leaf is split over both, its
experts over data and its d_ff over model). Every value the update needs
over a whole leaf (the global norm here; Adafactor's means and RMS) sums
the blocks over each group that splits it, and a leaf whole on every
rank of a group counts once: its grad is already the whole grad there
(a replicated leaf's grad is never summed over the model group, which
would double it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

Tree = Dict


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in the JAX flatten order (sorted keys)."""
    return list(_iter_leaves(tree))


def _iter_leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter_leaves(tree[k])
    else:
        yield tree


def tree_unflatten(like, leaves) -> Tree:
    """A tree shaped as `like` whose leaves, in flatten order, are the
    items of `leaves` (the inverse of tree_leaves)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class Shards:
    """Which param leaves a rank holds only a block of: `dims` mirrors the
    params with each leaf's dim split over the data group (None: whole
    on every rank; dist.sharding.data_dims), and `group` sums over that
    group (dist.collectives.AxesGroup: the same bits on every rank);
    `model_dims` and `model_group` the same for the model axis
    (dist.sharding.model_dims; None without one)."""
    dims: Tree
    group: Any
    model_dims: Optional[Tree] = None
    model_group: Any = None

    def splits(self) -> List[Tuple[Tree, Any]]:
        """(dims tree, group) for each group that may split a leaf, the
        data group first."""
        out = [(self.dims, self.group)]
        if self.model_dims is not None:
            out.append((self.model_dims, self.model_group))
        return out


def clip_by_global_norm(grads: Tree, max_norm: float,
                        shards: Optional[Shards] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)) in f32 and
    cast back to each leaf's dtype, the f32 global norm: the sqrt of the
    sum over leaves, in flatten order, of each leaf's f32 sum of
    squares). With `shards` a split leaf's sum of squares is its block's
    summed over each group that splits it (one all-reduce a group for all
    of them, the data group first); a leaf whole on a group's ranks
    counts once."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if shards is not None:
        for dims, group in shards.splits():
            split = [i for i, d in enumerate(tree_leaves(dims))
                     if d is not None]
            if split and group.size > 1:
                summed = group.all_reduce(torch.stack([sq[i]
                                                       for i in split]))
                for j, i in enumerate(split):
                    sq[i] = summed[j]
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_fn: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params: Tree) -> Tree:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: Tree,
               shards: Optional[Shards] = None
               ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
        """One step. Returns (params, state, {"grad_norm", "lr"}); params,
        m and v are the given tensors (a rank's blocks under `shards`),
        updated in place."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm, shards)
        step = state["step"] + 1
        lr = self.lr_fn(step)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g) * (1 - b2))
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            pf = p.float()
            delta.add_(self.weight_decay * pf)
            p.copy_(pf - lr * delta)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "step": step}, \
            {"grad_norm": gnorm, "lr": lr}
