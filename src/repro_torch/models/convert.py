"""Carry weights, optimizer state and caches across from the JAX package.

The two packages draw different random weights from the same seed, so a
parity test hands the JAX params to the port instead: exported to numpy
by the caller (`jax.tree.map(np.asarray, params)`), then turned into the
port's params here with their bf16 bit patterns kept. The port itself
never imports jax; it only reads numpy arrays (bf16 ones arrive as numpy
arrays of dtype "bfloat16", whose 16-bit patterns are copied as they are).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One numpy array -> tensor on `device`, bit for bit (bf16 via its
    16-bit patterns)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.asarray(a, order="C").view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(a, order="C").copy()).to(device)


class _Shapes:
    """A ParamInit stand-in that records shapes and allocates nothing."""

    def __init__(self):
        self.shapes: Dict[str, tuple] = {}

    def param(self, path, shape, axes, init="normal", dtype=None, *,
              parts=1):
        self.shapes[path] = tuple(shape)
        return path


def _flatten(tree: Dict, pre: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def params_from_numpy(tree: Dict, cfg: ModelConfig,
                      device=backend.DEFAULT_DEVICE) -> Dict:
    """The JAX param tree of `cfg` (numpy leaves: dense or vlm, hybrid, moe
    with its "dense_layers" and "layers/moe/*", ssm (rwkv6) with
    "layers/tm/*" and "layers/cm/*", or encdec (whisper) with
    "enc_layers", "dec_layers" (and "dec_layers/xattn/*"), "enc_ln",
    "enc_lnb", "dec_pos" and "final_normb") as the port's params on
    `device`, each leaf bit for bit in its own dtype.
    Raises ValueError when a path is missing or extra, or a shape differs
    from the one the port builds."""
    dev = backend.resolve_device(device)
    rec = _Shapes()
    skeleton = T.build_param_fn(cfg)(rec)
    given = _flatten(tree)
    if set(given) != set(rec.shapes):
        raise ValueError(f"param paths differ: missing "
                         f"{sorted(set(rec.shapes) - set(given))}, extra "
                         f"{sorted(set(given) - set(rec.shapes))}")
    for path, shape in rec.shapes.items():
        if tuple(np.shape(given[path])) != shape:
            raise ValueError(f"{path}: shape {np.shape(given[path])}, the "
                             f"port builds {shape}")

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return tensor_from_numpy(given[node], dev)

    return fill(skeleton)


def opt_state_from_numpy(state: Dict, device=backend.DEFAULT_DEVICE) -> Dict:
    """A JAX optimizer state (AdamW {"m", "v", "step"} or Adafactor {"f",
    "step"}; numpy leaves) as the port's on `device`: every leaf bit for
    bit, "step" a 0-d int32 tensor."""
    dev = backend.resolve_device(device)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return fill(state)


def cache_from_numpy(cache: Dict, device=backend.DEFAULT_DEVICE) -> Dict:
    """A JAX decode cache (numpy leaves: dense and vlm {"k", "v", "pos"};
    moe also "dk"/"dv" of its dense layers; hybrid also "conv" bf16 and
    "h" f32; encdec also the cross-attention's "xk"/"xv" bf16; ssm {"wkv"
    f32, "tm", "cm" bf16, "pos"}) as the port's cache on `device`, every
    leaf bit for bit in its own dtype; pos becomes an int32 tensor
    (scalar or (B,))."""
    dev = backend.resolve_device(device)
    out = {k: tensor_from_numpy(v, dev) for k, v in cache.items()
           if k != "pos"}
    out["pos"] = torch.as_tensor(np.array(cache["pos"], np.int32),
                                 device=dev)
    return out
