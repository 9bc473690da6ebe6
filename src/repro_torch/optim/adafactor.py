"""Adafactor (Shazeer & Stern 2018) with factored second moments — the
port of `repro.optim.adafactor`, plus `make_optimizer`.

Factored for leaves of rank >= 2 (row and column running means of the
squared grads over the last two axes), a full second moment for vectors;
update clipping at RMS 1.0; no first moment. State: {"f": tree of
{"vr", "vc"} or {"v"} f32, "step": int32 0-d}. As the port's AdamW, the
update writes params and the moments IN PLACE under torch.no_grad() and
returns the same dicts with a new "step".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.optim.adamw import (AdamW, clip_by_global_norm, tree_leaves,
                                    tree_map)

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
    def update(self, params: Tree, grads: Tree, state: Tree
               ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        step = state["step"] + 1
        lr = self.lr_fn(step)
        beta2 = 1.0 - step.float() ** (-self.decay)

        def upd(p, g, s):
            g = g.float()
            g2 = torch.square(g) + self.eps
            if self._factored(p.shape):
                s["vr"].copy_(beta2 * s["vr"] + (1 - beta2) * g2.mean(-1))
                s["vc"].copy_(beta2 * s["vc"] + (1 - beta2) * g2.mean(-2))
                vr, vc = s["vr"], s["vc"]
                rfac = torch.rsqrt(vr / torch.clamp_min(
                    vr.mean(-1, keepdim=True), self.eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)
                u = g * torch.rsqrt(s["v"])
            # update clipping (RMS(u) <= d)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            pf = p.float()
            p.copy_(pf - lr * (u + self.weight_decay * pf))

        _map_state(upd, params, grads, state["f"])
        return params, {"f": state["f"], "step": step}, \
            {"grad_norm": gnorm, "lr": lr}


def _map_state(fn, params, grads, states):
    """fn(param, grad, state dict) over the param leaves; the factored
    state of a leaf is itself a dict ({"vr", "vc"} or {"v"})."""
    if isinstance(params, dict):
        for k in params:
            _map_state(fn, params[k], grads[k], states[k])
    else:
        fn(params, grads, states)


def make_optimizer(name: str, lr_fn):
    """AdamW or Adafactor with their defaults around `lr_fn`."""
    if name == "adamw":
        return AdamW(lr_fn=lr_fn)
    if name == "adafactor":
        return Adafactor(lr_fn=lr_fn)
    raise ValueError(name)
