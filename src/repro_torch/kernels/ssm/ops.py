"""Public ssm op layer — the port of `repro.kernels.ssm.ops`.

    from repro_torch.kernels.ssm import ops
    y, hT = ops.ssm_scan(x, dt, bmat, cmat, a_log, d, h0)

Thin wrapper over `repro_torch.kernels.api.dispatch("ssm", ...)`:
version=None runs the hand-written kernel ("cuda") under the tuned blk_c
for this (B, T, C, N); version="ref"/"chunked" run the plain torch forms.
"""

from __future__ import annotations

from typing import Optional

from repro_torch import backend
from repro_torch.kernels import api


def ssm_scan(x, dt, bmat, cmat, a_log, d, h0, *,
             version: Optional[str] = None, config=None,
             device=backend.DEFAULT_DEVICE, problem_key=None):
    """Same contract as models/mamba.ssm_scan: x, dt: (B,T,C);
    bmat/cmat: (B,T,N); a_log: (C,N); d: (C,); h0: (B,C,N).
    Returns (y (B,T,C) f32, hT (B,C,N) f32), on `device` (the card unless
    device='cpu').

    problem_key: optional SsmKey overriding the shape-derived one, so a
    caller keys the tune cache on the problem it runs (the JAX package's
    sharded call sites key it on the per-shard channel count)."""
    return api.dispatch("ssm", x, dt, bmat, cmat, a_log, d, h0,
                        version=version, config=config, device=device,
                        problem_key=problem_key)
