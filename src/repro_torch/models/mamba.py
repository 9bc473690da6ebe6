"""Selective SSM (Mamba-style) path of the Hymba hybrid block — the port of
`repro.models.mamba`.

h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (A diagonal, state N)
y_t = C_t . h_t + D * x_t

Evaluated three ways, with the JAX package's contracts:
  * `ssm_scan`    — the sequential oracle (the JAX `lax.scan` as a Python
                    loop over T);
  * `ssm_chunked` — chunk-parallel: sequential across chunks, the
                    cumulative-decay form inside a chunk;
  * `ssm_decode`  — the single-token state update.

The depthwise causal conv1d (kernel CONV_K) that precedes the SSM keeps a
(B, K-1, C) tail for decode. The hand-written scan kernel is
`repro_torch.kernels.ssm` (csrc/ssm_scan.cu).
"""

from __future__ import annotations

import torch

CONV_K = 4


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, conv_state=None):
    """Depthwise causal conv. x: (B,T,C); w: (K,C). conv_state: (B,K-1,C)
    tail of the previous segment (decode/streaming), zeros when None.
    Accumulates the taps in f32 in tap order and casts back to x's dtype.
    Returns (out (B,T,C), new tail (B,K-1,C) in x's dtype)."""
    b, t, c = x.shape
    k = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)      # (B, T+K-1, C)
    out = torch.zeros((b, t, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + t].float() * w[i].float()
    return out.to(x.dtype), xp[:, -(k - 1):]


def ssm_scan(x, dt, bmat, cmat, a_log, d, h0, *, dtype=torch.float32):
    """Sequential oracle.
    x, dt: (B,T,C);  bmat, cmat: (B,T,N);  a_log: (C,N) (A = -exp(a_log));
    d: (C,); h0: (B,C,N). Returns (y (B,T,C), hT (B,C,N)), computed in
    `dtype` (f32, as the JAX package; float64 measures how far an f32
    result is from exact arithmetic on the same inputs)."""
    a = -torch.exp(a_log.to(dtype))                        # (C,N)
    h = h0.to(dtype)
    ys = []
    for t in range(x.shape[1]):
        xt, dtt = x[:, t].to(dtype), dt[:, t].to(dtype)   # (B,C)
        bt, ct = bmat[:, t].to(dtype), cmat[:, t].to(dtype)   # (B,N)
        da = torch.exp(dtt[..., None] * a[None])          # (B,C,N)
        dbx = (dtt * xt)[..., None] * bt[:, None, :]      # (B,C,N)
        h = da * h + dbx
        ys.append(torch.einsum("bcn,bn->bc", h, ct))
    y = torch.stack(ys, dim=1) + x.to(dtype) * d.to(dtype)[None, None]
    return y, h


def ssm_chunked(x, dt, bmat, cmat, a_log, d, h0, *, chunk: int = 64):
    """Chunk-parallel selective scan (same contract as ssm_scan).

    Inside a chunk with La_t = sum_{s<=t} dt_s*A (cumulative, per (C,N)):
      h_t = exp(La_t) h_0 + sum_{s<=t} exp(La_t - La_s) dt_s B_s x_s
      y_t = C_t . h_t
    """
    b, t, c = x.shape
    n = a_log.shape[1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk {chunk}")
    a = -torch.exp(a_log.float())                          # (C,N)
    h = h0.float()
    ys = []
    for c0 in range(0, t, chunk):
        xc = x[:, c0:c0 + chunk].float()                   # (B,S,C)
        dtc = dt[:, c0:c0 + chunk].float()
        bc = bmat[:, c0:c0 + chunk].float()                # (B,S,N)
        cc = cmat[:, c0:c0 + chunk].float()
        da = dtc[..., None] * a[None, None]                # (B,S,C,N)
        la = torch.cumsum(da, dim=1)                       # inclusive
        # clamp: exp(-la) must stay in f32 range; the pairwise factors
        # exp(la_t - la_s) stay correct to ~e-60 absolute under the clamp
        # (both operands clamp together), the GLA/SSD stabilization
        la = torch.clamp_min(la, -60.0)
        hh = torch.exp(la) * h[:, None]                    # (B,S,C,N)
        y = torch.einsum("bscn,bsn->bsc", hh, cc)
        u = dtc * xc                                       # (B,S,C)
        e_pos = torch.exp(la)
        e_neg = torch.exp(-la)
        rhs = u[..., None] * bc[:, :, None, :] * e_neg     # (B,S,C,N)
        acc = torch.cumsum(rhs, dim=1)                     # prefix over s<=t
        y = y + torch.einsum("bscn,bsn->bsc", acc * e_pos, cc)
        la_last = la[:, -1]                                # (B,C,N)
        h = torch.exp(la_last) * h + \
            torch.einsum("bscn->bcn", rhs * torch.exp(la_last[:, None]))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + x.float() * d.float()[None, None]
    return y, h


def ssm_decode(xt, dtt, bt, ct, a_log, d, h):
    """One token. xt, dtt: (B,C); bt, ct: (B,N); h: (B,C,N)."""
    a = -torch.exp(a_log.float())
    da = torch.exp(dtt[..., None] * a[None])
    h = da * h + (dtt * xt)[..., None] * bt[:, None, :]
    y = torch.einsum("bcn,bn->bc", h, ct) + xt * d.float()[None]
    return y, h
