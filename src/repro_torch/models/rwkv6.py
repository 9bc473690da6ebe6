"""RWKV-6 "Finch" time-mix with data-dependent decay (arXiv:2404.05892) —
the port of `repro.models.rwkv6` (`wkv6_scan` :26, `wkv6_chunked` :40,
`wkv6_decode` :91, `LORA_MIX`/`LORA_DECAY` :103-104, `ddlerp` :107 and
`token_shift` :116).

Recurrence (per head, k-dim i, v-dim j):
    y_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    S_t    = diag(w_t) S_{t-1} + k_t v_t^T ,  w_t = exp(-exp(wlog_t))

Three evaluators, with the JAX package's contracts, all f32:
  * `wkv6_scan`    — the sequential oracle (the JAX `lax.scan` as a Python
                     loop over T);
  * `wkv6_chunked` — chunk-parallel (GLA-style): sequential across chunks
                     (a Python loop, as `models/mamba.py`), the
                     cumulative-decay form inside a chunk, clamped at -60
                     exactly as the reference clamps it. Under that clamp
                     the chunked form is NOT the scan once a chunk's
                     cumulative log-decay passes -60 (at the model's
                     initial decay, w ~ e^-1 a step, that is step ~60 of a
                     64-step chunk); it matches the reference's chunked
                     form, which is what the port is held to;
  * `wkv6_decode`  — the single-token state update.

WKV is pure JAX in the reference, so it is plain torch here: no kernel.
"""

from __future__ import annotations

import torch

LORA_MIX = 32     # TIME_MIX_EXTRA_DIM
LORA_DECAY = 64   # TIME_DECAY_EXTRA_DIM


def wkv6_scan(r, k, v, w, u, state):
    """Sequential oracle. r/k/v/w: (B,T,H,D); u: (H,D); state: (B,H,D,D).
    Returns (y (B,T,H,D), new state), computed in the inputs' dtype (f32,
    as the JAX package; float64 measures how far an f32 result lies from
    exact arithmetic on the same inputs)."""
    s = state
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]     # (B,H,D)
        kv = kt[..., :, None] * vt[..., None, :]                 # (B,H,Dk,Dv)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = 64):
    """Chunked parallel WKV6; the same signature as wkv6_scan.

    Within a chunk (length C) with cumulative log-decay
    La_t = sum_{s<=t} log w_s (inclusive, floored at log 1e-38 a step and
    clamped at -60):
      inter:  y_t += (r_t * exp(La_{t-1})) @ S_0
      intra:  y_t += sum_{s<t} [r_t . (exp(La_{t-1}-La_s) * k_s)] v_s
      bonus:  y_t += (r_t . (u * k_t)) v_t
      carry:  S_C = diag(exp(La_C)) S_0 + sum_s (exp(La_C - La_s) * k_s) v_s^T
    """
    b, t, h, d = r.shape
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk {chunk}")
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    s = state
    ys = []
    for c0 in range(0, t, chunk):
        # (B,H,C,D) slices of the chunk
        rc, kc, vc, wc = (a[:, c0:c0 + chunk].transpose(1, 2)
                          for a in (r, k, v, w))
        logw = torch.log(torch.clamp_min(wc, 1e-38))
        la = torch.cumsum(logw, dim=2)                     # inclusive
        # the reference's stability clamp: keeps exp(-la) finite in f32
        la = torch.clamp_min(la, -60.0)
        # exclusive cumulative decay (shifted right by one step)
        la_excl = torch.nn.functional.pad(la[:, :, :-1], (0, 0, 1, 0))
        r_t = rc * torch.exp(la_excl)                      # r-tilde
        k_s = kc * torch.exp(-la)                          # k-tilde
        y = torch.einsum("bhcd,bhde->bhce", r_t, s)        # inter-chunk
        att = torch.einsum("bhcd,bhsd->bhcs", r_t, k_s)    # intra-chunk
        att = torch.where(mask, att, 0.0)
        y = y + torch.einsum("bhcs,bhse->bhce", att, vc)
        bonus = torch.sum(rc * u[None, :, None, :] * kc, -1, keepdim=True)
        y = y + bonus * vc
        la_last = la[:, :, -1:, :]                         # (B,H,1,D)
        k_carry = kc * torch.exp(la_last - la)
        s = torch.exp(la_last[:, :, 0, :, None]) * s + \
            torch.einsum("bhcd,bhce->bhde", k_carry, vc)
        ys.append(y.transpose(1, 2))                       # (B,C,H,D)
    return torch.cat(ys, dim=1), s


def wkv6_decode(r, k, v, w, u, state):
    """One token. r/k/v/w: (B,H,D); state (B,H,Dk,Dv) f32."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    return y, w[..., :, None] * state + kv


def ddlerp(x, x_prev, mu, lora_a, lora_b):
    """Data-dependent lerp (the Finch token-shift). x, x_prev: (B,T,D) in
    the activations' dtype, every elementwise step rounded to it; the LoRA
    products in f32."""
    diff = x_prev - x
    xx = x + diff * mu[0]
    delta = torch.tanh(xx.float() @ lora_a.float())
    delta = (delta @ lora_b.float()).to(x.dtype)
    return x + diff * (mu[1] + delta)


def token_shift(x, shift_state):
    """x: (B,T,D); shift_state: (B,D) = last token of the previous segment.
    Returns (the previous token of every position, x's last token)."""
    prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    return prev, x[:, -1]
