"""Adafactor (Shazeer & Stern 2018) with factored second moments — the
port of `repro.optim.adafactor`, plus `make_optimizer`.

Factored for leaves of rank >= 2 (row and column running means of the
squared grads over the last two axes), a full second moment for vectors;
update clipping at RMS 1.0; no first moment. State: {"f": tree of
{"vr", "vc"} or {"v"} f32, "step": int32 0-d}. As the port's AdamW, the
update writes params and the moments IN PLACE under torch.no_grad() and
returns the same dicts with a new "step".

Under `Shards` a leaf split on dim d keeps its stats split only where
the param is (dist.sharding.opt_state_specs): a mean over d (vr's over
the last dim, vc's over the second-last, rfac's mean of vr) sums the
blocks over each group that splits d (the data group's, the model
group's, or both in that order where FSDP and TP split one dim) and
divides by the whole length, the update's RMS over the whole leaf sums
over every group that splits the leaf, once each; every other mean stays
local.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.optim.adamw import (AdamW, Shards, clip_by_global_norm,
                                    tree_leaves, tree_map)

Tree = Dict


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr_fn: Callable[[torch.Tensor], torch.Tensor]
    decay: float = 0.8            # \hat\beta_2t exponent base
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0

    def _factored(self, shape) -> bool:
        return len(shape) >= 2

    def init(self, params: Tree) -> Tree:
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if self._factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        dev = tree_leaves(params)[0].device
        return {"f": tree_map(leaf, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, params: Tree, grads: Tree, state: Tree,
               shards: Optional[Shards] = None
               ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm, shards)
        step = state["step"] + 1
        lr = self.lr_fn(step)
        beta2 = 1.0 - step.float() ** (-self.decay)
        splits = [] if shards is None else shards.splits()

        def mean(t, axis, groups, keepdim=False):
            if not groups:
                return t.mean(axis, keepdim=keepdim)
            tot, n = t.sum(axis, keepdim=keepdim), t.shape[axis]
            for group in groups:
                tot, n = group.all_reduce(tot), n * group.size
            return tot / n

        def upd(p, g, s, dims):
            nd = p.dim()
            # the groups that split each of p's dims, the data group first
            # (none: whole)
            by_dim = {}
            for d, (_, group) in zip(dims, splits):
                if d is not None:
                    by_dim.setdefault(d % nd, []).append(group)
            g = g.float()
            g2 = torch.square(g) + self.eps
            if self._factored(p.shape):
                s["vr"].copy_(beta2 * s["vr"]
                              + (1 - beta2) * mean(g2, -1, by_dim.get(nd - 1)))
                s["vc"].copy_(beta2 * s["vc"]
                              + (1 - beta2) * mean(g2, -2, by_dim.get(nd - 2)))
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / torch.clamp_min(
                    mean(vr, -1, by_dim.get(nd - 2), keepdim=True),
                    self.eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)
                u = g * torch.rsqrt(s["v"])
            # update clipping (RMS(u) <= d)
            if not by_dim:
                ms = torch.mean(torch.square(u))
            else:
                tot, n = torch.sum(torch.square(u)), u.numel()
                for groups in by_dim.values():
                    for group in groups:
                        tot, n = group.all_reduce(tot), n * group.size
                ms = tot / n
            rms = torch.sqrt(ms + 1e-30)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            pf = p.float()
            p.copy_(pf - lr * (u + self.weight_decay * pf))

        _map_state(upd, params, grads, state["f"],
                   [dims for dims, _ in splits])
        return params, {"f": state["f"], "step": step}, \
            {"grad_norm": gnorm, "lr": lr}


def _map_state(fn, params, grads, states, dims):
    """fn(param, grad, state dict, its split dim in each tree of `dims`)
    over the param leaves; the factored state of a leaf is itself a dict
    ({"vr", "vc"} or {"v"})."""
    if isinstance(params, dict):
        for k in params:
            _map_state(fn, params[k], grads[k], states[k],
                       [d[k] for d in dims])
    else:
        fn(params, grads, states, dims)


def make_optimizer(name: str, lr_fn):
    """AdamW or Adafactor with their defaults around `lr_fn`."""
    if name == "adamw":
        return AdamW(lr_fn=lr_fn)
    if name == "adafactor":
        return Adafactor(lr_fn=lr_fn)
    raise ValueError(name)
