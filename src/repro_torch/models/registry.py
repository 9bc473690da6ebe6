"""Model assembly: config -> Model (init / prefill / decode_step /
prefill_into_slot / init_cache) — the port of `repro.models.registry` for
the dense family (`Model` :31, `_dense_prefill_stack` :114,
`_dense_decode_stack` :137, the dense `make_cache` :347, `build_model`
:426, `_logits` :458, `prefill` :559, `decode_step` :652,
`prefill_into_slot` :726).

Layouts are the JAX package's: activations (B, S, D), caches
{"k", "v": (L, B, Lcache, KvH, Hd) bf16, "pos": int32 scalar or (B,)},
params with the JAX tree's keys. PyTorch runs eagerly, so the layer scan
is a Python loop over the stacked params, and the decode steps update the
cache's k/v IN PLACE (the returned cache shares them; only "pos" is a new
tensor), where the JAX steps return new arrays.

`loss_fn`, `decode_verify`, `prefill_continue` and every family but
"dense" wait for later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import (PARAM_DTYPE, ParamInit, embed,
                                       lm_logits, rms_norm, swiglu)

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init_params: Callable[..., Dict]
    prefill: Callable[..., Tuple[torch.Tensor, Cache]]
    decode_step: Callable[..., Tuple[torch.Tensor, Cache]]
    # single-row prefill written into one slot of a batched decode cache
    # (continuous batching refill — see serve/engine.py)
    prefill_into_slot: Callable[..., Tuple[torch.Tensor, Cache]]
    init_cache: Callable[..., Cache]


# ===========================================================================
# forward stacks
# ===========================================================================

def _layer(layers: Dict, i: int) -> Dict:
    """Layer i's params: views into the stacked (L, ...) leaves."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _dense_prefill_stack(cfg: ModelConfig, layers, x, positions, *,
                         window: int = 0, kv_valid=None):
    """Run the decoder layers over x (B,S,D); also emits the per-layer
    (k, v), stacked to (L, B, S, KvH, Hd)."""
    ks, vs = [], []
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = T.attn_block(lp["attn"], h, cfg, positions=positions,
                                 window=window, kv_valid=kv_valid)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h, lp["ffn"]["wi"], lp["ffn"]["wg"], lp["ffn"]["wo"])
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _dense_decode_stack(cfg: ModelConfig, layers, x, cache: Cache, *,
                        window: int = 0):
    pos = cache["pos"]
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = T.attn_block_decode(lp["attn"], h, cfg, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos,
                                   window=window)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h, lp["ffn"]["wi"], lp["ffn"]["wg"], lp["ffn"]["wo"])
    return x, {**cache, "pos": pos + 1}


# ===========================================================================
# cache construction
# ===========================================================================

def make_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=backend.DEFAULT_DEVICE) -> Cache:
    """Decode-state dict of the dense family on `device` (the card unless
    device='cpu'): zeroed k/v of (L, batch, cache_len, KvH, Hd) bf16 and a
    scalar int32 pos."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP queue 1, item 8)")
    dev = backend.resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=PARAM_DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=PARAM_DTYPE, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


# ===========================================================================
# build_model
# ===========================================================================

def build_model(cfg: ModelConfig) -> Model:
    """Assemble a `Model` for one dense config: init_params / prefill /
    decode_step / prefill_into_slot / init_cache, in the JAX package's
    layouts. Any other family raises NotImplementedError naming its
    ROADMAP item.

    Example::

        import torch, repro_torch
        cfg = repro_torch.get_config("qwen2-1.5b")          # full width
        model = repro_torch.build_model(cfg)
        params = model.init_params(0)                       # on the card
        logits, cache = model.prefill(params, {"tokens": torch.ones(
            (1, 8), dtype=torch.long, device="cuda")})
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port builds the "
            "dense family only (ROADMAP queue 1, item 8 lists the others)")
    param_fn = T.build_param_fn(cfg)

    def init_params(seed: int = 0, device=backend.DEFAULT_DEVICE) -> Dict:
        """Random params from `seed` (N(0,1) x 0.02 and ones, as the JAX
        ParamBuilder; other values than jax.random's) on `device`."""
        return param_fn(ParamInit(seed, backend.resolve_device(device)))

    def _logits(params, x):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        table = params["embed"].T if cfg.tie_embeddings else params["head"]
        return lm_logits(x, table)

    def prefill(params, batch, *, last_index=None):
        """Full forward; returns (last-token logits (B,1,V) f32, cache).

        batch["tokens"]: (B, S) int. batch may carry "pad_lens" — a (B,)
        count of LEFT pad tokens per row: positions then start at 0 on each
        row's first real token and pad key/value columns are masked out of
        every softmax. last_index: optional index into the sequence axis
        (int or 0-d tensor); the logits are taken there instead of at -1
        (prefill_into_slot: a right-padded row's last real token)."""
        tokens = batch["tokens"]
        x = embed(tokens, params["embed"])
        s = x.shape[1]
        dev = x.device
        pad_lens = batch.get("pad_lens")
        if pad_lens is None:
            positions = torch.arange(s, device=dev)
            kv_valid = None
        else:
            pad_lens = torch.as_tensor(pad_lens, device=dev)
            ar = torch.arange(s, device=dev)[None, :]
            positions = torch.clamp_min(ar - pad_lens[:, None], 0)
            kv_valid = ar >= pad_lens[:, None]
        x, ks, vs = _dense_prefill_stack(cfg, params["layers"], x, positions,
                                         kv_valid=kv_valid)
        cache = {"k": ks, "v": vs,
                 "pos": torch.tensor(s, dtype=torch.int32, device=dev)}
        if last_index is None:
            last = x[:, -1:]
        else:
            idx = torch.as_tensor(last_index, device=dev).long().reshape(1)
            last = x.index_select(1, idx)
        return _logits(params, last), cache

    def decode_step(params, cache: Cache, tokens):
        """tokens: (B, 1). Returns (logits (B,1,V) f32, cache): k/v are
        written in place, "pos" (a scalar or a (B,) per-row vector)
        advances by one in a new tensor."""
        x = embed(tokens, params["embed"])
        x, cache = _dense_decode_stack(cfg, params["layers"], x, cache)
        return _logits(params, x), cache

    def prefill_into_slot(params, cache: Cache, slot, batch, prompt_len):
        """Prefill ONE request (batch row of size 1) and overwrite `slot`'s
        cache lines in a batched decode cache whose "pos" is a (B,) per-row
        vector. batch["tokens"] is (1, P); P may exceed the real prompt
        (right padding to a shape bucket): pad lines land beyond
        prompt_len, stay masked by the per-row length, and are overwritten
        as decode advances. Logits are taken at prompt_len - 1.

        Returns (logits (1,1,V), cache): lines 0..P-1 of row `slot` in
        every layer's k/v are written in place (the JAX
        dynamic_update_slice at (0, slot, 0, ...)), and pos[slot] =
        prompt_len in a new "pos" tensor."""
        plen = torch.as_tensor(prompt_len, device=cache["pos"].device)
        logits, row = prefill(params, batch, last_index=plen - 1)
        p = row["k"].shape[2]
        cache["k"][:, slot, :p] = row["k"][:, 0]
        cache["v"][:, slot, :p] = row["v"][:, 0]
        pos = cache["pos"].clone()
        pos[slot] = plen.to(pos.dtype)
        return logits, {**cache, "pos": pos}

    return Model(cfg=cfg, init_params=init_params, prefill=prefill,
                 decode_step=decode_step, prefill_into_slot=prefill_into_slot,
                 init_cache=functools.partial(make_cache, cfg))
