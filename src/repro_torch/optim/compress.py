"""Gradient compression for the data-parallel all-reduce — the port of
`repro.optim.compress` (:25-98).

  * bf16 cast-before-sync is `grad_compress="bf16"` in train/step.py;
  * int8 with one scale a leaf and ERROR FEEDBACK: the quantization
    residual is carried to the next step, so the compression error stays
    O(1) over training instead of O(T) (Seide et al. / EF-SGD).

`allreduce_int8` is the reference's shard_map body on one rank of
explicit SPMD: the ranks agree on one scale a leaf (a max all-reduce
before quantizing, so every payload dequantizes against the same
quantum), sum the int8 payloads as int32, and divide the dequantized sum
by the group size. As in the JAX package, the train step has no int8
mode; these are the building blocks.

Every division by a constant (the scale's 127, the group size) divides
by a 0-d tensor on the operand's device (`_div`): on a CUDA tensor a
Python-number divisor becomes a multiply by its rounded reciprocal,
x * fl(1/127), which is not x / 127 for ~5% of f32 x, so the card's
scale sat one ulp from the CPU's and JAX's, and every quotient near a
half rounded to another int8.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

Tree = dict


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded in x's dtype on either device: d as a 0-d
    tensor on x's device (the true-divide kernel on both), never a
    Python number (which CUDA's kernel turns into x * fl(1/d))."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _quantize(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(gf / scale) (half to even, as jnp.round) clipped to +-127."""
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def ef_int8_compress(grads: Tree, residual: Tree
                     ) -> Tuple[Tree, Tree, Tree]:
    """Error-feedback int8 quantization of each leaf (grad + residual in
    f32, scale max|.| / 127, floored at 1e-12 / 127). Returns (q int8
    tree, scales tree (0-d f32), new residual tree)."""
    def leaf(g, r):
        gf = g.float() + r
        scale = _div(torch.clamp_min(torch.max(torch.abs(gf)), 1e-12), 127.0)
        q = _quantize(gf, scale)
        return q, scale, gf - q.float() * scale

    out = [leaf(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residual))]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def ef_int8_decompress(qs: Tree, scales: Tree) -> Tree:
    return tree_map(lambda q, s: q.float() * s, qs, scales)


def init_residual(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def allreduce_int8(grads: Tree, residual: Tree, group) -> Tuple[Tree, Tree]:
    """This rank's grads synchronised over `group` (a
    dist.collectives.AxesGroup over the data axes) through int8 payloads:
    per leaf, gf = grad + residual in f32; scale = max over the ranks of
    max|gf| (floored at 1e-12), / 127; q = round(gf / scale) clipped to
    +-127; the int32 sum of every rank's q, times scale, over the group
    size. Returns (the mean, the same on every rank; this rank's new
    residual gf - q scale)."""
    n = group.size

    def leaf(g, r):
        gf = g.float() + r
        scale = _div(group.all_reduce(torch.clamp_min(
            torch.max(torch.abs(gf)), 1e-12), op="max"), 127.0)
        q = _quantize(gf, scale)
        new_r = gf - q.float() * scale
        summed = group.all_reduce(q.to(torch.int32))
        return _div(summed.float() * scale, n), new_r

    out = [leaf(g, r) for g, r in zip(tree_leaves(grads),
                                      tree_leaves(residual))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
