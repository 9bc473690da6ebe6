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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Tuple

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


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)) in f32 and
    cast back to each leaf's dtype, the f32 global norm: the sqrt of the
    sum over leaves, in flatten order, of each leaf's f32 sum of
    squares)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
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
    def update(self, params: Tree, grads: Tree, state: Tree
               ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
        """One step. Returns (params, state, {"grad_norm", "lr"}); params,
        m and v are the given tensors, updated in place."""
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
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
