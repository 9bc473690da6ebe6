"""input_specs(): abstract stand-ins for every (arch x shape) cell — the
port of `repro.launch.specs`.

No memory is allocated: every leaf is a tensor on the "meta" device
(shape and dtype only). They drive the dry-run's census of a rank's step
(launch/dryrun.py, analyze.census.census_step) as the reference's
ShapeDtypeStructs drive its jit(...).lower(...). The modality frontends
are stubs, as in the reference: whisper gets precomputed frame
embeddings, internvl2 precomputed patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.layers import PARAM_DTYPE
from repro_torch.models.registry import make_cache

PyTree = Any


def _s(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                      frontend_dtype: torch.dtype = PARAM_DTYPE) -> Dict:
    """The global train batch of the cell. `frontend_dtype` is the stub
    frames' or patches' dtype: PARAM_DTYPE as in the reference; a Trainer
    feeds f32 (data.pipeline.make_stub_frontend_batch)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": _s((b, cfg.enc_seq, cfg.d_model), frontend_dtype),
                "tokens": _s((b, s)), "labels": _s((b, s))}
    if cfg.family == "vlm":
        st = s - cfg.n_vis_tokens          # text tokens; total positions = s
        return {"vis": _s((b, cfg.n_vis_tokens, cfg.d_model),
                          frontend_dtype),
                "tokens": _s((b, st)), "labels": _s((b, st))}
    return {"tokens": _s((b, s)), "labels": _s((b, s))}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return {"frames": _s((b, cfg.enc_seq, cfg.d_model), PARAM_DTYPE),
                "tokens": _s((b, s))}
    if cfg.family == "vlm":
        return {"vis": _s((b, cfg.n_vis_tokens, cfg.d_model), PARAM_DTYPE),
                "tokens": _s((b, s - cfg.n_vis_tokens))}
    return {"tokens": _s((b, s))}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Dict, PyTree]:
    """(token specs, abstract cache) for one decode step against a cache
    of the cell's seq_len."""
    b, s = shape.global_batch, shape.seq_len
    cache = make_cache(cfg, b, s, abstract=True)
    return {"tokens": _s((b, 1))}, cache


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Dispatch per the cell kind: {"kind", "batch", "cache" (decode
    only)}.

    Example::

        import repro_torch
        from repro_torch.launch.specs import input_specs
        cell = input_specs(repro_torch.get_config("qwen2-1.5b"), "train_4k")
        cell["kind"], cell["batch"]["tokens"].shape   # 'train' (256, 4096)
    """
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"kind": "train", "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"kind": "prefill", "batch": prefill_batch_specs(cfg, shape)}
    batch, cache = decode_specs(cfg, shape)
    return {"kind": "decode", "batch": batch, "cache": cache}
