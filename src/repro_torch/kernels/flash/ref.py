"""Exact (one-shot) softmax attention in f32 over (BH, S, Hd) planar heads
— the port of `repro.kernels.flash.ref`, the oracle the flash kernel and
its plain version are held against."""

from __future__ import annotations

import torch


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (BH, S, Hd); k/v: (BKvH, S, Hd). Exact attention in f32, cast to
    q's dtype."""
    bh, sq, hd = q.shape
    group = bh // k.shape[0]
    kk = torch.repeat_interleave(k, group, dim=0).float()
    vv = torch.repeat_interleave(v, group, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), kk) * hd ** -0.5
    if causal:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(j <= i, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vv).to(q.dtype)
