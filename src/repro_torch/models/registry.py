"""Model assembly: config -> Model (init / loss / prefill / decode_step /
prefill_into_slot / init_cache) — the port of `repro.models.registry` for
the dense and hybrid families (`Model` :31, `_maybe_remat` :60,
`_dense_stack` :92, `_dense_prefill_stack` :114, `_dense_decode_stack`
:137, `_hymba_stack` :186-252 for prefill and decode, `make_cache` :347,
`build_model` :426, `_logits` :458, `loss_fn` :516, `prefill` :559,
`decode_step` :652, `prefill_into_slot` :726).

Layouts are the JAX package's: activations (B, S, D), caches
{"k", "v": (L, B, Lcache, KvH, Hd) bf16, "pos": int32 scalar or (B,)},
plus for the hybrid family (whose k/v keep only the attention window, a
ring buffer: Lcache = cfg.attn_window) {"conv": (L, B, K-1, Ci) bf16,
"h": (L, B, Ci, N) f32}; params with the JAX tree's keys. PyTorch runs
eagerly, so the layer scan is a Python loop over the stacked params, and
the decode steps update every cache leaf but "pos" IN PLACE (the returned
cache shares them; only "pos" is a new tensor), where the JAX steps
return new arrays.

Training (dense only): `loss_fn` runs `_dense_stack`, each layer under
`torch.utils.checkpoint` as `cfg.remat` says ("none"; "full"; "dots",
which keeps the non-batched matmul outputs, the JAX
`dots_with_no_batch_dims_saveable`), then the cross-entropy in sequence
chunks, each under its own checkpoint. Serving (`prefill`, `decode_step`,
`prefill_into_slot`) runs under `torch.no_grad()`, so params that require
grad (a trainer's) record no graph there.

`decode_verify`, `prefill_continue`, hybrid training and every family but
"dense" and "hybrid" wait for later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba as mamba_lib
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


# --- hymba -----------------------------------------------------------------

def _hymba_fuse(cfg: ModelConfig, lp, attn_out, ssm_out):
    """The mean of the two paths, each under its own norm."""
    a = rms_norm(attn_out, lp["mamba"]["norm_attn"], cfg.norm_eps)
    s = rms_norm(ssm_out, lp["mamba"]["norm_ssm"], cfg.norm_eps)
    return 0.5 * (a + s)


def _hymba_prefill_stack(cfg: ModelConfig, layers, x, positions):
    """The hybrid layers over x (B,S,D): windowed attention beside the
    mamba path. Also emits the cache: each layer's last min(S, w) k/v in
    the ring layout (line i holds the position p with p % w == i, the JAX
    roll(k[:, -w:], S % w)), stacked to (L, B, min(S, w), KvH, Hd), and
    the conv tails and h states, stacked to (L, ...)."""
    w = cfg.attn_window
    s = x.shape[1]
    ks, vs, convs, hs = [], [], [], []
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = T.attn_block(lp["attn"], h, cfg, positions=positions,
                                 window=w)
        m, conv_st, h_st = T.mamba_path(lp["mamba"], h, cfg)
        x = x + _hymba_fuse(cfg, lp, a, m)
        hh = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(hh, lp["ffn"]["wi"], lp["ffn"]["wg"], lp["ffn"]["wo"])
        ks.append(torch.roll(k[:, -w:], shifts=s % w, dims=1))
        vs.append(torch.roll(v[:, -w:], shifts=s % w, dims=1))
        convs.append(conv_st)
        hs.append(h_st)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "conv": torch.stack(convs), "h": torch.stack(hs)}


def _hymba_decode_stack(cfg: ModelConfig, layers, x, cache: Cache):
    """One token through the hybrid layers: ring-buffer attention and the
    mamba decode step; k/v, conv and h are written in place."""
    pos = cache["pos"]
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = T.attn_block_decode(lp["attn"], h, cfg, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos, ring=True)
        m, conv_st, h_st = T.mamba_path(lp["mamba"], h, cfg,
                                        conv_state=cache["conv"][i],
                                        h_state=cache["h"][i], decode=True)
        cache["conv"][i].copy_(conv_st)
        cache["h"][i].copy_(h_st)
        x = x + _hymba_fuse(cfg, lp, a, m)
        hh = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(hh, lp["ffn"]["wi"], lp["ffn"]["wg"], lp["ffn"]["wo"])
    return x, {**cache, "pos": pos + 1}


# ===========================================================================
# cache construction
# ===========================================================================

def make_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=backend.DEFAULT_DEVICE) -> Cache:
    """Decode-state dict on `device` (the card unless device='cpu'), zeroed,
    with a scalar int32 pos. Dense: k/v of (L, batch, cache_len, KvH, Hd)
    bf16. Hybrid: cache_len is the longest context served, but the
    attention keeps only its window: k/v of (L, batch, attn_window, KvH,
    Hd) bf16, conv (L, batch, CONV_K - 1, Ci) bf16 and h (L, batch, Ci, N)
    f32, Ci = 2 d_model."""
    if cfg.family not in T.PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP queue 1, item 8)")
    dev = backend.resolve_device(device)
    L = cfg.n_layers
    lines = cfg.attn_window if cfg.family == "hybrid" else cache_len
    shape = (L, batch, lines, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=PARAM_DTYPE, device=dev),
             "v": torch.zeros(shape, dtype=PARAM_DTYPE, device=dev),
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.family == "hybrid":
        ci = 2 * cfg.d_model
        cache["conv"] = torch.zeros((L, batch, mamba_lib.CONV_K - 1, ci),
                                    dtype=PARAM_DTYPE, device=dev)
        cache["h"] = torch.zeros((L, batch, ci, cfg.ssm_state),
                                 dtype=torch.float32, device=dev)
    return cache


# ===========================================================================
# build_model
# ===========================================================================

def build_model(cfg: ModelConfig) -> Model:
    """Assemble a `Model` for one dense or hybrid config: init_params /
    loss_fn / prefill / decode_step / prefill_into_slot / init_cache, in
    the JAX package's layouts. Any other family raises NotImplementedError
    naming its ROADMAP item, and so does the hybrid family's loss_fn.

    Example::

        import torch, repro_torch
        cfg = repro_torch.get_config("qwen2-1.5b")          # full width
        model = repro_torch.build_model(cfg)
        params = model.init_params(0)                       # on the card
        logits, cache = model.prefill(params, {"tokens": torch.ones(
            (1, 8), dtype=torch.long, device="cuda")})
    """
    if cfg.family not in T.PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port builds "
            f"{T.PORTED_FAMILIES} (ROADMAP queue 1, item 8 lists the others)")
    param_fn = T.build_param_fn(cfg)

    def init_params(seed: int = 0, device=backend.DEFAULT_DEVICE) -> Dict:
        """Random params from `seed` (N(0,1) x 0.02 and ones, as the JAX
        ParamBuilder; other values than jax.random's) on `device`."""
        return param_fn(ParamInit(seed, backend.resolve_device(device)))

    def _logits(params, x):
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        table = params["embed"].T if cfg.tie_embeddings else params["head"]
        return lm_logits(x, table)

    @backend.f32_accumulation()
    def loss_fn(params, batch):
        """(total, {"loss", "aux", "ntokens"}) of batch["tokens"] (B, S)
        against batch["labels"] (B, S): the mean over labels >= 0 of the
        cross-entropy with z-loss 1e-4, all f32 scalars. The xent runs in
        sequence chunks (512, 256, 128 or 64, the largest that divides S
        and is below it), each under its own checkpoint, so one (B, chunk,
        V) f32 logits block is live at a time."""
        if cfg.family != "dense":
            raise NotImplementedError(
                f"loss_fn of the {cfg.family!r} family is not ported yet: "
                "hybrid training is module work of ROADMAP queue 1, item "
                "8.2 (the training stack of _hymba_stack)")
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

    @backend.f32_accumulation()
    @torch.no_grad()
    def prefill(params, batch, *, last_index=None):
        """Full forward; returns (last-token logits (B,1,V) f32, cache).

        batch["tokens"]: (B, S) int. batch may carry "pad_lens" — a (B,)
        count of LEFT pad tokens per row: positions then start at 0 on each
        row's first real token and pad key/value columns are masked out of
        every softmax. last_index: optional index into the sequence axis
        (int or 0-d tensor); the logits are taken there instead of at -1
        (prefill_into_slot: a right-padded row's last real token).

        Hybrid: pad_lens raises ValueError (the recurrent state would
        consume the pads), and the cache's k/v hold the last min(S,
        attn_window) positions in the ring layout."""
        tokens = batch["tokens"]
        x = embed(tokens, params["embed"])
        s = x.shape[1]
        dev = x.device
        pad_lens = batch.get("pad_lens")
        if pad_lens is not None and cfg.family != "dense":
            raise ValueError(
                "pad_lens (left-padded prefill) is only defined for pure "
                "attention stacks; the recurrent state of the "
                f"{cfg.family!r} family would consume the pads")
        if pad_lens is None:
            positions = torch.arange(s, device=dev)
            kv_valid = None
        else:
            pad_lens = torch.as_tensor(pad_lens, device=dev)
            ar = torch.arange(s, device=dev)[None, :]
            positions = torch.clamp_min(ar - pad_lens[:, None], 0)
            kv_valid = ar >= pad_lens[:, None]
        if cfg.family == "hybrid":
            x, cache = _hymba_prefill_stack(cfg, params["layers"], x,
                                            positions)
        else:
            x, ks, vs = _dense_prefill_stack(cfg, params["layers"], x,
                                             positions, kv_valid=kv_valid)
            cache = {"k": ks, "v": vs}
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=dev)
        if last_index is None:
            last = x[:, -1:]
        else:
            idx = torch.as_tensor(last_index, device=dev).long().reshape(1)
            last = x.index_select(1, idx)
        return _logits(params, last), cache

    @backend.f32_accumulation()
    @torch.no_grad()
    def decode_step(params, cache: Cache, tokens):
        """tokens: (B, 1). Returns (logits (B,1,V) f32, cache): k/v (and
        the hybrid family's conv and h) are written in place, "pos" (a
        scalar or a (B,) per-row vector) advances by one in a new tensor."""
        x = embed(tokens, params["embed"])
        stack = (_hymba_decode_stack if cfg.family == "hybrid"
                 else _dense_decode_stack)
        x, cache = stack(cfg, params["layers"], x, cache)
        return _logits(params, x), cache

    @backend.f32_accumulation()
    @torch.no_grad()
    def prefill_into_slot(params, cache: Cache, slot, batch, prompt_len):
        """Prefill ONE request (batch row of size 1) and overwrite `slot`'s
        cache lines in a batched decode cache whose "pos" is a (B,) per-row
        vector. batch["tokens"] is (1, P); P may exceed the real prompt
        (right padding to a shape bucket): pad lines land beyond
        prompt_len, stay masked by the per-row length, and are overwritten
        as decode advances. For the hybrid family (recurrent state folds
        every token in) P must equal the real prompt length. Logits are
        taken at prompt_len - 1.

        Returns (logits (1,1,V), cache): row `slot` of every cache leaf
        but "pos" is written in place from the row's prefill cache, its
        leading lines along the third axis (the JAX dynamic_update_slice
        at (0, slot, 0, ...) of each leaf: P k/v lines, min(P, window) of
        them for the hybrid ring, the whole conv tail and h state), and
        pos[slot] = prompt_len in a new "pos" tensor."""
        plen = torch.as_tensor(prompt_len, device=cache["pos"].device)
        logits, row = prefill(params, batch, last_index=plen - 1)
        for key, full in cache.items():
            if key != "pos":
                part = row[key][:, 0]
                full[:, slot, :part.shape[1]] = part.to(full.dtype)
        pos = cache["pos"].clone()
        pos[slot] = plen.to(pos.dtype)
        return logits, {**cache, "pos": pos}

    return Model(cfg=cfg, init_params=init_params, loss_fn=loss_fn,
                 prefill=prefill,
                 decode_step=decode_step, prefill_into_slot=prefill_into_slot,
                 init_cache=functools.partial(make_cache, cfg))
