"""Model assembly: config -> Model (init / loss / prefill / decode_step /
prefill_into_slot / init_cache) — the port of `repro.models.registry` for
the dense family (`Model` :31, `_maybe_remat` :60, `_dense_stack` :92,
`_dense_prefill_stack` :114, `_dense_decode_stack` :137, the dense
`make_cache` :347, `build_model` :426, `_logits` :458, `loss_fn` :516,
`prefill` :559, `decode_step` :652, `prefill_into_slot` :726).

Layouts are the JAX package's: activations (B, S, D), caches
{"k", "v": (L, B, Lcache, KvH, Hd) bf16, "pos": int32 scalar or (B,)},
params with the JAX tree's keys. PyTorch runs eagerly, so the layer scan
is a Python loop over the stacked params, and the decode steps update the
cache's k/v IN PLACE (the returned cache shares them; only "pos" is a new
tensor), where the JAX steps return new arrays.

Training: `loss_fn` runs `_dense_stack`, each layer under
`torch.utils.checkpoint` as `cfg.remat` says ("none"; "full"; "dots",
which keeps the non-batched matmul outputs, the JAX
`dots_with_no_batch_dims_saveable`), then the cross-entropy in sequence
chunks, each under its own checkpoint. Serving (`prefill`, `decode_step`,
`prefill_into_slot`) runs under `torch.no_grad()`, so params that require
grad (a trainer's) record no graph there.

`decode_verify`, `prefill_continue` and every family but "dense" wait for
later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import (PARAM_DTYPE, ParamInit, embed,
                                       lm_logits, rms_norm, softmax_xent,
                                       swiglu)

Cache = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    init_params: Callable[..., Dict]
    # (params, batch) -> (total loss, {"loss", "aux", "ntokens"}), f32
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
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


def _unstack(layers: Dict) -> List[Dict]:
    """Every layer's params as views of the stacked (L, ...) leaves, each
    leaf split by one `torch.unbind`: its backward stacks the L layer
    gradients in one copy (L single-layer `select`s would each scatter
    into a zeroed (L, ...) gradient)."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return torch.unbind(node, 0)

    def pick(node, i):
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]

    parts = split(layers)
    return [pick(parts, i) for i in range(layers["ln1"].shape[0])]


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of non-batched matrix
    products (aten mm / addmm: the projections), recompute the rest (the
    batched attention einsums, norms, casts)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat: str):
    """fn under torch.utils.checkpoint (non-reentrant) as the JAX
    `_maybe_remat`: "none" keeps every activation, "dots" keeps the
    non-batched matmul outputs, anything else ("full") keeps only fn's
    inputs and recomputes fn in the backward."""
    if remat == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_saveable)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=context_fn)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _dense_stack(cfg: ModelConfig, layers, x, positions, *, remat: str):
    """The decoder layers over x (B,S,D) for training, each under
    `_maybe_remat`. Returns (x, aux loss), aux 0 for the dense family."""

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = T.attn_block(lp["attn"], h, cfg, positions=positions)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + swiglu(h, lp["ffn"]["wi"], lp["ffn"]["wg"],
                          lp["ffn"]["wo"])

    body = _maybe_remat(body, remat)
    for lp in _unstack(layers):
        x = body(x, lp)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
    """Assemble a `Model` for one dense config: init_params / loss_fn /
    prefill / decode_step / prefill_into_slot / init_cache, in the JAX
    package's layouts. Any other family raises NotImplementedError naming its
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

    def loss_fn(params, batch):
        """(total, {"loss", "aux", "ntokens"}) of batch["tokens"] (B, S)
        against batch["labels"] (B, S): the mean over labels >= 0 of the
        cross-entropy with z-loss 1e-4, all f32 scalars. The xent runs in
        sequence chunks (512, 256, 128 or 64, the largest that divides S
        and is below it), each under its own checkpoint, so one (B, chunk,
        V) f32 logits block is live at a time."""
        x = embed(batch["tokens"], params["embed"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = _dense_stack(cfg, params["layers"], x, positions,
                              remat=cfg.remat)
        labels = batch["labels"]
        s = x.shape[1]
        chunk = s
        for c in (512, 256, 128, 64):
            if s % c == 0 and s > c:
                chunk = c
                break

        def xent_chunk(x_c, labels_c):
            logits = _logits(params, x_c)
            mask = (labels_c >= 0).float()
            per_tok = softmax_xent(logits, torch.clamp_min(labels_c, 0))
            return (per_tok * mask).sum(), mask.sum()

        if chunk == s:
            lsum, msum = xent_chunk(x, labels)
        else:
            from torch.utils.checkpoint import checkpoint
            lsum = msum = torch.zeros((), dtype=torch.float32,
                                      device=x.device)
            for c0 in range(0, s, chunk):
                dl, dm = checkpoint(xent_chunk, x[:, c0:c0 + chunk],
                                    labels[:, c0:c0 + chunk],
                                    use_reentrant=False)
                lsum, msum = lsum + dl, msum + dm
        ntok = torch.clamp_min(msum, 1.0)
        loss = lsum / ntok
        total = loss + cfg.router_aux_coef * aux
        return total, {"loss": loss, "aux": aux, "ntokens": ntok}

    @torch.no_grad()
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

    @torch.no_grad()
    def decode_step(params, cache: Cache, tokens):
        """tokens: (B, 1). Returns (logits (B,1,V) f32, cache): k/v are
        written in place, "pos" (a scalar or a (B,) per-row vector)
        advances by one in a new tensor."""
        x = embed(tokens, params["embed"])
        x, cache = _dense_decode_stack(cfg, params["layers"], x, cache)
        return _logits(params, x), cache

    @torch.no_grad()
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

    return Model(cfg=cfg, init_params=init_params, loss_fn=loss_fn,
                 prefill=prefill,
                 decode_step=decode_step, prefill_into_slot=prefill_into_slot,
                 init_cache=functools.partial(make_cache, cfg))
