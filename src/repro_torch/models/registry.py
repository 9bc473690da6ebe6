"""Model assembly: config -> Model (init / loss / prefill / decode_step /
prefill_into_slot / init_cache) — the port of `repro.models.registry` for
every family: dense, moe, ssm (rwkv6), hybrid, encdec (whisper) and vlm
(internvl2) (`Model` :31, `_maybe_remat` :60, `_moe_apply` :69 (the
capacity route, in `_ffn`), `_dense_stack` :92, `_dense_prefill_stack`
:114, `_dense_decode_stack` :137, `_rwkv_stack` :162 in its train,
prefill and decode forms, `_hymba_stack` :186-252 in the same three,
`_whisper_encode` :255, `_whisper_dec_stack` :276 in the same three,
`make_cache` :347, `build_model` :426, `_logits` :458, `_backbone_train`
:468, `loss_fn` :516, `prefill` :559, `decode_step` :652,
`decode_verify` :691, `prefill_into_slot` :726, `prefill_continue`
:763).

Layouts are the JAX package's: activations (B, S, D), caches
{"k", "v": (L, B, Lcache, KvH, Hd) bf16, "pos": int32 scalar or (B,)},
plus for the hybrid family (whose k/v keep only the attention window, a
ring buffer: Lcache = cfg.attn_window) {"conv": (L, B, K-1, Ci) bf16,
"h": (L, B, Ci, N) f32}; for the moe family k/v cover the L -
first_k_dense moe layers and "dk"/"dv" the first_k_dense dense ones; the
ssm family (rwkv6) has no k/v but {"wkv": (L, B, H, Hd, Hd) f32, "tm",
"cm": (L, B, D) bf16} (the WKV state and the time and channel mixes'
last inputs); the encdec family (whisper) adds the cross-attention's
{"xk", "xv": (L, B, enc_seq, KvH, Hd) bf16}, written by prefill and only
read by decode; the vlm family's is the dense cache, its lines counting
the n_vis_tokens patch embeddings before the text. Params with the JAX
tree's keys. PyTorch runs eagerly, so the layer scan is a Python loop
over the stacked params, and the decode steps update every cache leaf
but "pos" IN PLACE (the returned cache shares them; only "pos" is a new
tensor), where the JAX steps return new arrays.

Whisper: batch["frames"] (B, enc_seq, D) stands in for the conv frontend
and keeps its own dtype: f32 frames keep the encoder's residual stream
in f32 (JAX promotes frames + the bf16 positions), and its projections
then multiply an f32 activation by the bf16-valued weights
(layers.matmul). The encoder, the cross-attention and the decoder's
self-attention run chunked attention, never flash, as in the JAX
package. vlm: batch["vis"] (B, n_vis_tokens, D) is cast to bf16 and
prepended to the text's embeddings; the loss counts the text positions
only.

Training (every family): `loss_fn` runs the family's train stack, each
layer under `torch.utils.checkpoint` as `cfg.remat` says ("none";
"full"; "dots", which keeps the non-batched matmul outputs, the JAX
`dots_with_no_batch_dims_saveable`), then the cross-entropy in sequence
chunks, each under its own checkpoint; the moe layers' router aux losses
are summed into the total at `cfg.router_aux_coef`. The hybrid train
stack runs windowed chunked attention (never flash, as in the JAX
package) beside `mamba_path` by `cfg.ssm_impl`; "pallas" raises in the
backward (`transformer.SsmScanNoGrad`). The rwkv train stack starts from
zero states and discards the states it ends with. Whisper's encoder
layers run under the same remat as its decoder's (the JAX encoder keeps
its scan's residuals: the same numbers, more memory). Serving
(`prefill`, `decode_step`, `decode_verify`, `prefill_into_slot`,
`prefill_continue`) runs under `torch.no_grad()`, so params that require
grad (a trainer's) record no graph there.

`prefill_continue` (the paged cache's suffix prefill) and `decode_verify`
(speculative decoding's multi-position step) are the dense family's only,
None for every other, as in the JAX package.

The sharding engine's inputs (dist/sharding.py), as the reference's
`Model`: `param_axes` (every param path's logical axes, recorded by
ParamInit), `cache_axes()` (`cache_logical_axes` :392) and
`abstract_params()` / `init_cache(..., abstract=True)` (the trees on the
"meta" device), and `param_parts` (the leaves that pack several tensors
side by side, ParamInit's parts=). `prefill`, `decode_step` and
`prefill_into_slot` take a `ctx` (layers.DistCtx) that every family's
serving stacks hand to their blocks: attention, the moe layers, the
mamba path, the rwkv time mix and whisper's encoder and cross-attention;
under layers.exact_tp_scope an untied head of an even vocab (one a
model axis of 2 splits) is K-blocked and its vocab-split logits gathered
whole (`_logits`); an odd vocab's head is replicated and one product.
`loss_fn` takes one too: over data axes it computes this rank's share of
the global batch's loss (data parallelism, train/step.py), and a moe
layer takes `_moe_apply`'s expert-parallel or global capacity route;
over a model axis (every family) every layer is row-parallel under the
reference's training plan (tensor-parallel training: attention, the
FFNs, mamba's path, rwkv6's mixes, whisper's encoder and
cross-attention on a rank's heads, channels or d_ff, the partials summed
over the model group), and the embedding and the loss are vocab-parallel
where the plan splits the vocab (an odd vocab's table and head stay
whole on every rank).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import copy_to
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T
from repro_torch.models.layers import (PARAM_DTYPE, DistCtx, ParamInit,
                                       embed, gather_exact_tp, gelu_ffn,
                                       in_exact_tp, layer_norm, lm_logits,
                                       matmul, matmul_rp, rms_norm,
                                       sinusoid_pos, softmax_xent, swiglu)

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
    # suffix-only prefill continuing from cached prefix K/V lines (paged
    # K/V cache prefix reuse — serve/kvcache.py); dense family only
    prefill_continue: Optional[Callable[..., Tuple[torch.Tensor, Cache]]] \
        = None
    # multi-position decode over draft candidates (speculative decoding —
    # serve/spec.py); dense family only
    decode_verify: Optional[Callable[..., Tuple[torch.Tensor, Cache]]] = None
    # the sharding engine's inputs (dist/sharding.py): every param path's
    # logical axes, the cache tree's (cache_logical_axes), and the param
    # tree on the "meta" device (shapes and dtypes, no memory)
    param_axes: Dict[str, Tuple[Optional[str], ...]] = dataclasses.field(
        default_factory=dict)
    # the paths of leaves that pack several tensors along their last dim,
    # and how many (ParamInit's parts=: mamba's in_proj, xs | z)
    param_parts: Dict[str, int] = dataclasses.field(default_factory=dict)
    cache_axes: Optional[Callable[[], Dict]] = None
    abstract_params: Optional[Callable[[], Dict]] = None


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


def _row_parallel(ctx, w: torch.Tensor, whole: int):
    """The model group where the training plan splits w's rows (dim -2,
    the contraction of a wo) of `whole` over it; None otherwise (one
    device, the serve plan's whole wo)."""
    return None if ctx is None else ctx.row_parallel(w.shape[-2], whole)


def _attn_tp(cfg: ModelConfig, ctx, at):
    """The model group where the training plan splits attention's wo rows
    (training, and the serving steps of train/step.py, over a model
    axis); None on one device or under the engine's serve plan, which
    keeps wo whole."""
    return _row_parallel(ctx, at["wo"], cfg.n_heads * cfg.head_dim)


def _mamba_tp(cfg: ModelConfig, ctx, mp):
    """The model group where the training plan splits the mamba channels
    (out_proj's rows); None under exact-TP or one device."""
    return _row_parallel(ctx, mp["out_proj"], 2 * cfg.d_model)


def _ffn(cfg: ModelConfig, lp, h, token_valid=None, ctx=None):
    """A layer's FFN over h (B,S,D). Returns (out, aux): a moe layer ("moe"
    in lp) runs `_moe_apply`, token_valid an optional flattened (B*S,)
    bool, False at pad tokens; a dense layer the SwiGLU, aux None, which
    is row-parallel where the training plan splits d_ff over the model
    axis (`layers.swiglu`'s tp)."""
    if "moe" in lp:
        return _moe_apply(cfg, lp["moe"], h, ctx, token_valid)
    f = lp["ffn"]
    return swiglu(h, f["wi"], f["wg"], f["wo"],
                  _row_parallel(ctx, f["wo"], cfg.d_ff)), None


EP_MIN_TOKENS = 4096


def _moe_apply(cfg: ModelConfig, lp_moe, h, ctx=None, token_valid=None):
    """The reference's `_moe_apply` (registry.py:69-88). Returns (out
    (B,S,D), aux), where aux is this rank's share of the global batch's
    router aux (the shares sum to it over the data axes; on one device
    it is the aux).

      * expert-parallel (ctx.ep_data on a mesh, no token_valid, and the
        GLOBAL token count, this rank's B*S times the data size, at least
        EP_MIN_TOKENS: JAX traces global shapes): moe.moe_ffn_ep over the
        data axes;
      * the capacity route over data axes of n > 1 ranks: the reference's
        moe_ffn competes over every token of the global batch, so the
        tokens (and token_valid) are gathered over the data axes in rank
        order, moe_ffn runs on them (with the experts gathered too where
        the plan split them), and this rank keeps its rows; the gathers'
        backward sends every grad to the rank that owns the tensor. aux
        is the global one, over n;
      * else moe_ffn on this batch's tokens.

    Where the training plan splits the experts' (or the shared experts')
    d_ff over the model axis, each route sums their row-parallel partials
    over the model group (`moe_ffn_ep`'s has_tp branch, `moe_ffn`'s tp)."""
    b_, s, d = h.shape
    flat = h.reshape(-1, d)
    n = 1 if ctx is None else ctx.data_size
    f_e = cfg.moe_d_ff or cfg.d_ff
    kw = dict(n_experts=cfg.n_experts, k=cfg.experts_per_token,
              tp=_row_parallel(ctx, lp_moe["wo"], f_e))
    if "shared_wo" in lp_moe:
        kw["shared_tp"] = _row_parallel(ctx, lp_moe["shared_wo"],
                                        f_e * cfg.n_shared_experts)
    if (ctx is not None and ctx.ep_data and ctx.mesh is not None
            and b_ * s * n >= EP_MIN_TOKENS and token_valid is None):
        f, aux = moe_lib.moe_ffn_ep(flat, lp_moe, group=ctx.data_group(),
                                    **kw)
        return f.reshape(b_, s, d), aux
    if n == 1:
        f, aux = moe_lib.moe_ffn(flat, lp_moe, token_valid=token_valid, **kw)
        return f.reshape(b_, s, d), aux
    from repro_torch.dist.collectives import GatherDim
    group = ctx.data_group()
    params = dict(lp_moe)
    if params["wi"].shape[0] != cfg.n_experts:       # experts split (EP)
        for name in ("wi", "wg", "wo"):
            params[name] = GatherDim.apply(params[name], 0, group)
    tv = None if token_valid is None else group.all_gather(token_valid, 0)
    f, aux = moe_lib.moe_ffn(GatherDim.apply(flat, 0, group), params,
                             token_valid=tv, **kw)
    rows = flat.shape[0]
    f = f[ctx.data_rank * rows:(ctx.data_rank + 1) * rows]
    return f.reshape(b_, s, d), aux / n


def _dense_stack(cfg: ModelConfig, layers, x, positions, *, remat: str,
                 ctx=None):
    """The decoder layers (dense or moe) over x (B,S,D) for training, each
    under `_maybe_remat`. Returns (x, the layers' aux losses (this rank's
    shares, `_moe_apply`) summed in layer order; 0 for dense layers).
    Under the training plan over a model axis (ctx) attention and the
    FFNs run on this rank's heads and d_ff and sum their row-parallel
    partials over the model group; x, the norms and the residual stream
    are whole and the same on every rank of it, and a remat recompute
    issues the forward's collectives again, in the same order on every
    rank."""

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        at = lp["attn"]
        a, _ = T.attn_block(at, h, cfg, positions=positions,
                            tp=_attn_tp(cfg, ctx, at))
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        f, aux = _ffn(cfg, lp, h, ctx=ctx)
        return x + f, aux

    body = _maybe_remat(body, remat)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(layers):
        x, aux = body(x, lp)
        if aux is not None:
            total = total + aux
    return x, total


def _dense_prefill_stack(cfg: ModelConfig, layers, x, positions, *,
                         window: int = 0, kv_valid=None, ctx=None):
    """Run the decoder layers (dense or moe) over x (B,S,D); also emits the
    per-layer (k, v), stacked to (L, B, S, KvH, Hd). A moe layer gets
    kv_valid, flattened, as its token_valid: pad tokens claim no expert
    capacity. Under the training plan over a model axis (the prefill step
    of train/step.py) attention and the FFN are row-parallel, as in
    training, and k/v are the heads `T._qkv_row_parallel` gives."""
    ks, vs = [], []
    tv = None if kv_valid is None else kv_valid.reshape(-1)
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = T.attn_block(lp["attn"], h, cfg, positions=positions,
                                 window=window, kv_valid=kv_valid, ctx=ctx,
                                 tp=_attn_tp(cfg, ctx, lp["attn"]))
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h, tv, ctx)[0]
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _dense_decode_stack(cfg: ModelConfig, layers, x, cache: Cache, *,
                        window: int = 0, ctx=None):
    pos = cache["pos"]
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = T.attn_block_decode(lp["attn"], h, cfg, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos,
                                   window=window, ctx=ctx,
                                   tp=_attn_tp(cfg, ctx, lp["attn"]))
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h, ctx=ctx)[0]
    return x, {**cache, "pos": pos + 1}


# --- rwkv ------------------------------------------------------------------

def _rwkv_layer(cfg: ModelConfig, lp, x, wkv, tm_shift, cm_shift, *,
                decode: bool = False, ctx=None):
    """One rwkv layer: the time mix and the channel mix, each behind its
    norm and residual. Returns (x, new wkv state, the time and channel
    mixes' last inputs). Under the training plan over a model axis (ctx)
    both mixes are row-parallel (tm/wo's rows, cm/wv's d_ff)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, tm_last, wkv = T.rwkv_time_mix(
        lp["tm"], h, tm_shift, wkv, cfg, decode=decode, ctx=ctx,
        tp=_row_parallel(ctx, lp["tm"]["wo"], cfg.d_model))
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    c, cm_last = T.rwkv_channel_mix(lp["cm"], h, cm_shift, _row_parallel(
        ctx, lp["cm"]["wv"], cfg.d_ff))
    return x + c, wkv, tm_last, cm_last


def _rwkv_zero_states(cfg: ModelConfig, x, ctx=None):
    """The zero wkv state (B, H', Hd, Hd) f32 (H' this rank's heads under
    exact-TP, or the training plan, where the model axis divides them,
    else every head) and shift input (B, D) of a segment that starts from
    nothing."""
    hd = cfg.rwkv_head_dim
    b_, d = x.shape[0], cfg.d_model
    h = d // hd
    if ctx is not None:
        h //= ctx.tp_shards(h)
    wkv = torch.zeros((b_, h, hd, hd), dtype=torch.float32,
                      device=x.device)
    return wkv, torch.zeros((b_, d), dtype=x.dtype, device=x.device)


def _rwkv_train_stack(cfg: ModelConfig, layers, x, *, remat: str,
                      ctx=None):
    """The rwkv layers over x (B,S,D) for training, each under
    `_maybe_remat`, from zero states (a rank's heads under the training
    plan over a model axis, ctx); the states they end with are
    discarded."""

    def body(x, lp):
        wkv, shift = _rwkv_zero_states(cfg, x, ctx)
        return _rwkv_layer(cfg, lp, x, wkv, shift, shift, ctx=ctx)[0]

    body = _maybe_remat(body, remat)
    for lp in _unstack(layers):
        x = body(x, lp)
    return x


def _rwkv_prefill_stack(cfg: ModelConfig, layers, x, ctx=None):
    """The rwkv layers over x (B,S,D) from zero states. Also emits the
    cache: each layer's wkv state (this rank's heads under exact-TP) and
    last time/channel-mix inputs, stacked to (L, ...)."""
    wkvs, tms, cms = [], [], []
    for i in range(layers["ln1"].shape[0]):
        wkv, shift = _rwkv_zero_states(cfg, x, ctx)
        x, wkv, tm_last, cm_last = _rwkv_layer(cfg, _layer(layers, i), x,
                                               wkv, shift, shift, ctx=ctx)
        wkvs.append(wkv)
        tms.append(tm_last)
        cms.append(cm_last)
    return x, {"wkv": torch.stack(wkvs), "tm": torch.stack(tms),
               "cm": torch.stack(cms)}


def _rwkv_decode_stack(cfg: ModelConfig, layers, x, cache: Cache,
                       ctx=None):
    """One token through the rwkv layers; wkv, tm and cm are written in
    place."""
    for i in range(layers["ln1"].shape[0]):
        x, wkv, tm_last, cm_last = _rwkv_layer(
            cfg, _layer(layers, i), x, cache["wkv"][i], cache["tm"][i],
            cache["cm"][i], decode=True, ctx=ctx)
        cache["wkv"][i].copy_(wkv)
        cache["tm"][i].copy_(tm_last)
        cache["cm"][i].copy_(cm_last)
    return x, {**cache, "pos": cache["pos"] + 1}


# --- hymba -----------------------------------------------------------------

def _hymba_fuse(cfg: ModelConfig, lp, attn_out, ssm_out):
    """The mean of the two paths, each under its own norm."""
    a = rms_norm(attn_out, lp["mamba"]["norm_attn"], cfg.norm_eps)
    s = rms_norm(ssm_out, lp["mamba"]["norm_ssm"], cfg.norm_eps)
    return 0.5 * (a + s)


def _hymba_stack(cfg: ModelConfig, layers, x, positions, *, remat: str,
                 ctx=None):
    """The hybrid layers over x (B,S,D) for training, each under
    `_maybe_remat`: windowed chunked attention beside `mamba_path` by
    cfg.ssm_impl (no flash: the window rules it out, as in the JAX
    package), no aux and no cache. Under the training plan over a model
    axis (ctx) attention (whole on every rank where a rank holds part of
    a head: hymba-1.5b's 25 heads at TP 2), the mamba path and the FFN
    are row-parallel, and the fuse's norms act on their sums."""

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        at, mp = lp["attn"], lp["mamba"]
        a, _ = T.attn_block(at, h, cfg, positions=positions,
                            window=cfg.attn_window, tp=_attn_tp(cfg, ctx, at))
        m, _, _ = T.mamba_path(mp, h, cfg, tp=_mamba_tp(cfg, ctx, mp))
        x = x + _hymba_fuse(cfg, lp, a, m)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + _ffn(cfg, lp, h, ctx=ctx)[0]

    body = _maybe_remat(body, remat)
    for lp in _unstack(layers):
        x = body(x, lp)
    return x


def _hymba_prefill_stack(cfg: ModelConfig, layers, x, positions,
                         ctx=None):
    """The hybrid layers over x (B,S,D): windowed attention beside the
    mamba path. Also emits the cache: each layer's last min(S, w) k/v in
    the ring layout (line i holds the position p with p % w == i, the JAX
    roll(k[:, -w:], S % w)), stacked to (L, B, min(S, w), KvH, Hd), and
    the conv tails and h states, stacked to (L, ...). Under exact-TP
    (ctx) attention takes its heads as `_qkv` gives them (hymba-1.5b's
    25 / 5 heads do not split over 2 ranks: gathered whole, the k/v cache
    whole), the mamba path and the FFN a rank's channels (the conv and h
    states the rank's)."""
    w = cfg.attn_window
    s = x.shape[1]
    ks, vs, convs, hs = [], [], [], []
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = T.attn_block(lp["attn"], h, cfg, positions=positions,
                                 window=w, ctx=ctx,
                                 tp=_attn_tp(cfg, ctx, lp["attn"]))
        m, conv_st, h_st = T.mamba_path(lp["mamba"], h, cfg, ctx=ctx,
                                        tp=_mamba_tp(cfg, ctx, lp["mamba"]))
        x = x + _hymba_fuse(cfg, lp, a, m)
        hh = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh, ctx=ctx)[0]
        ks.append(torch.roll(k[:, -w:], shifts=s % w, dims=1))
        vs.append(torch.roll(v[:, -w:], shifts=s % w, dims=1))
        convs.append(conv_st)
        hs.append(h_st)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "conv": torch.stack(convs), "h": torch.stack(hs)}


def _hymba_decode_stack(cfg: ModelConfig, layers, x, cache: Cache,
                        ctx=None):
    """One token through the hybrid layers: ring-buffer attention and the
    mamba decode step; k/v, conv and h are written in place."""
    pos = cache["pos"]
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = T.attn_block_decode(lp["attn"], h, cfg, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos, ring=True,
                                   ctx=ctx, tp=_attn_tp(cfg, ctx, lp["attn"]))
        m, conv_st, h_st = T.mamba_path(lp["mamba"], h, cfg,
                                        conv_state=cache["conv"][i],
                                        h_state=cache["h"][i], decode=True,
                                        ctx=ctx,
                                        tp=_mamba_tp(cfg, ctx, lp["mamba"]))
        cache["conv"][i].copy_(conv_st)
        cache["h"][i].copy_(h_st)
        x = x + _hymba_fuse(cfg, lp, a, m)
        hh = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, hh, ctx=ctx)[0]
    return x, {**cache, "pos": pos + 1}


# --- whisper (encdec) ------------------------------------------------------

def _whisper_attn(cfg: ModelConfig, at, h, ctx, *, causal: bool = True,
                  kv_x=None):
    """Whisper's attention over h (its self-attention, or with kv_x the
    cross-attention over the encoder output), chunked and without rope,
    never flash, as in the JAX package. Returns (out, (k, v)). Under
    exact-TP (ctx) it runs on this rank's heads (`_qkv`, heads=), gathered
    before the whole wo (matmul_rp); under the training plan over a model
    axis (wo's rows split) on the rank's heads of `_qkv_row_parallel`
    (kv_x through CopyToGroup), wo's partials summed over the group."""
    b_, s, _ = h.shape
    tp = _attn_tp(cfg, ctx, at)
    if tp is not None:
        q, k, v, cols = T._qkv_row_parallel(at, h, cfg, tp, kv_x=kv_x)
        a = attn_lib.chunked_causal_attention(q, k, v, causal=causal)
        return T.attn_out_row_parallel(at, a, cols, tp), (k, v)
    q, k, v = T._qkv(at, h, cfg, ctx, kv_x=kv_x)
    a = attn_lib.chunked_causal_attention(q, k, v, causal=causal,
                                          heads=T._kv_heads(cfg, ctx))
    return matmul_rp(a.reshape(b_, s, -1), at["wo"]), (k, v)


def _whisper_encode(cfg: ModelConfig, params, frames, *, remat: str = "none",
                    ctx=None):
    """frames: (B, enc_seq, D) stub embeddings -> the encoder output
    (B, enc_seq, D) after its final LayerNorm, in the type of frames +
    the bf16 positions (f32 for f32 frames). Bidirectional chunked
    attention; each layer under `_maybe_remat`. Under exact-TP (ctx) the
    self-attention runs on this rank's heads and the gelu FFN on its d_ff
    columns, each gathered before its whole down projection (matmul_rp):
    the output is whole on every rank. Under the training plan over a
    model axis (ctx) both are row-parallel, their partials summed (in
    f32, rounded once) into the stream, whole on every rank."""
    x = frames + sinusoid_pos(frames.shape[1], cfg.d_model,
                              device=frames.device)[None]

    def body(x, lp):
        h = layer_norm(x, lp["ln1"], lp["ln1b"], cfg.norm_eps)
        x = x + _whisper_attn(cfg, lp["attn"], h, ctx, causal=False)[0]
        h = layer_norm(x, lp["ln2"], lp["ln2b"], cfg.norm_eps)
        return x + _gelu(cfg, lp, h, ctx)

    body = _maybe_remat(body, remat)
    for lp in _unstack(params["enc_layers"]):
        x = body(x, lp)
    return layer_norm(x, params["enc_ln"], params["enc_lnb"], cfg.norm_eps)


def _gelu(cfg: ModelConfig, lp, h, ctx=None):
    """A whisper layer's gelu FFN, row-parallel where the training plan
    splits its d_ff over the model axis (`layers.gelu_ffn`'s tp)."""
    f = lp["ffn"]
    return gelu_ffn(h, f["wi"], f["bi"], f["wo"], f["bo"],
                    _row_parallel(ctx, f["wo"], cfg.d_ff))


def _whisper_dec_layer(cfg: ModelConfig, lp, x, enc_out, ctx=None):
    """One decoder layer over x (B,S,D): causal self-attention, then
    cross-attention over enc_out, then the gelu FFN, each behind its
    LayerNorm and residual. Returns (x, (k, v, xk, xv)): the
    self-attention's and cross-attention's keys and values (this rank's
    heads under exact-TP or the training plan, ctx)."""
    h = layer_norm(x, lp["ln1"], lp["ln1b"], cfg.norm_eps)
    a, (k, v) = _whisper_attn(cfg, lp["attn"], h, ctx)
    x = x + a
    h = layer_norm(x, lp["lnx"], lp["lnxb"], cfg.norm_eps)
    a, (xk, xv) = _whisper_attn(cfg, lp["xattn"], h, ctx, causal=False,
                                kv_x=enc_out)
    x = x + a
    h = layer_norm(x, lp["ln2"], lp["ln2b"], cfg.norm_eps)
    return x + _gelu(cfg, lp, h, ctx), (k, v, xk, xv)


def _whisper_train_stack(cfg: ModelConfig, layers, x, enc_out, *,
                         remat: str, ctx=None):
    """The decoder layers over x (B,S,D) for training, each under
    `_maybe_remat`; no cache. ctx: as `_whisper_dec_layer`'s."""

    def body(x, lp, enc_out):
        return _whisper_dec_layer(cfg, lp, x, enc_out, ctx)[0]

    body = _maybe_remat(body, remat)
    for lp in _unstack(layers):
        x = body(x, lp, enc_out)
    return x


def _whisper_prefill_stack(cfg: ModelConfig, layers, x, enc_out, ctx=None):
    """The decoder layers over x (B,S,D); also emits the cache: each
    layer's k/v and cross-attention xk/xv, stacked to (L, ...)."""
    outs = {"k": [], "v": [], "xk": [], "xv": []}
    for i in range(layers["ln1"].shape[0]):
        x, kvs = _whisper_dec_layer(cfg, _layer(layers, i), x, enc_out, ctx)
        for key, t in zip(("k", "v", "xk", "xv"), kvs):
            outs[key].append(t)
    return x, {key: torch.stack(ts) for key, ts in outs.items()}


def _whisper_decode_stack(cfg: ModelConfig, layers, x, cache: Cache,
                          ctx=None):
    """One token through the decoder layers: self-attention against k/v
    (written in place, no rope), cross-attention against every line of
    xk/xv (read only); this rank's heads under exact-TP (ctx)."""
    pos = cache["pos"]
    b_ = x.shape[0]
    heads = T._kv_heads(cfg, ctx)
    for i in range(layers["ln1"].shape[0]):
        lp = _layer(layers, i)
        h = layer_norm(x, lp["ln1"], lp["ln1b"], cfg.norm_eps)
        a, _ = T.attn_block_decode(lp["attn"], h, cfg, cache_k=cache["k"][i],
                                   cache_v=cache["v"][i], pos=pos,
                                   rope=False, ctx=ctx,
                                   tp=_attn_tp(cfg, ctx, lp["attn"]))
        x = x + a
        h = layer_norm(x, lp["lnx"], lp["lnxb"], cfg.norm_eps)
        xk, xv = cache["xk"][i], cache["xv"][i]
        q = matmul(h, lp["xattn"]["wq"])
        tp = _attn_tp(cfg, ctx, lp["xattn"])
        if tp is not None:
            # the training plan: the rank's heads where xk/xv hold its kv
            # heads, else every head; wo's rows take their columns
            q = T.decode_heads_tp(q, cfg.n_heads, cfg.head_dim, tp,
                                  xk.shape[2] < cfg.n_kv_heads)
            a = attn_lib.decode_attention(q, xk, xv, xk.shape[1])
            x = x + T.out_rows_tp(lp["xattn"]["wo"], a, tp)
        else:
            if not T.local_heads(cfg, ctx):
                q = gather_exact_tp(q, cfg.n_heads * cfg.head_dim)
            q = q.reshape(b_, 1, -1, cfg.head_dim)
            a = attn_lib.decode_attention(q, xk, xv, xk.shape[1],
                                          heads=heads)
            x = x + matmul_rp(a.reshape(b_, 1, -1), lp["xattn"]["wo"])
        h = layer_norm(x, lp["ln2"], lp["ln2b"], cfg.norm_eps)
        x = x + _gelu(cfg, lp, h, ctx)
    return x, {**cache, "pos": pos + 1}


# ===========================================================================
# cache construction
# ===========================================================================

def make_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=backend.DEFAULT_DEVICE, *, abstract: bool = False
               ) -> Cache:
    """Decode-state dict on `device` (the card unless device='cpu'), zeroed,
    with a scalar int32 pos. Dense and vlm: k/v of (L, batch, cache_len,
    KvH, Hd) bf16 (vlm's lines hold the patch embeddings' keys, then the
    text's). Encdec (whisper): those k/v over the decoder layers, and
    xk/xv of (L, batch, enc_seq, KvH, Hd) bf16, the cross-attention's
    keys and values. Moe: k/v over the L - first_k_dense moe layers, and
    dk/dv of the same lines over the first_k_dense dense layers (when
    there are any). Ssm (rwkv6): no k/v, whatever cache_len; wkv (L,
    batch, H, Hd, Hd) f32 (H = d_model / rwkv_head_dim), tm and cm (L,
    batch, d_model) bf16. Hybrid: cache_len is the longest context served, but the
    attention keeps only its window: k/v of (L, batch, attn_window, KvH,
    Hd) bf16, conv (L, batch, CONV_K - 1, Ci) bf16 and h (L, batch, Ci, N)
    f32, Ci = 2 d_model. abstract=True: the same leaves on the "meta"
    device (shapes and dtypes, no memory)."""
    dev = torch.device("meta") if abstract else backend.resolve_device(device)
    L, d = cfg.n_layers, cfg.d_model
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_dim
        return {"wkv": torch.zeros((L, batch, d // hd, hd, hd),
                                   dtype=torch.float32, device=dev),
                "tm": torch.zeros((L, batch, d), dtype=PARAM_DTYPE,
                                  device=dev),
                "cm": torch.zeros((L, batch, d), dtype=PARAM_DTYPE,
                                  device=dev),
                "pos": pos}
    lines = cfg.attn_window if cfg.family == "hybrid" else cache_len

    def kv(n):
        return torch.zeros((n, batch, lines, cfg.n_kv_heads, cfg.head_dim),
                           dtype=PARAM_DTYPE, device=dev)

    kd = cfg.first_k_dense if cfg.family == "moe" else 0
    cache = {"k": kv(L - kd), "v": kv(L - kd), "pos": pos}
    if kd:
        cache["dk"], cache["dv"] = kv(kd), kv(kd)
    if cfg.family == "encdec":
        shape = (L, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["xk"] = torch.zeros(shape, dtype=PARAM_DTYPE, device=dev)
        cache["xv"] = torch.zeros(shape, dtype=PARAM_DTYPE, device=dev)
    if cfg.family == "hybrid":
        ci = 2 * d
        cache["conv"] = torch.zeros((L, batch, mamba_lib.CONV_K - 1, ci),
                                    dtype=PARAM_DTYPE, device=dev)
        cache["h"] = torch.zeros((L, batch, ci, cfg.ssm_state),
                                 dtype=torch.float32, device=dev)
    return cache


def cache_logical_axes(cfg: ModelConfig) -> Dict:
    """Logical axes of the cache tree (mirrors make_cache's structure; the
    reference's :392)."""
    kvax = ("layers", "batch", "kv_seq", "kv_heads", None)
    if cfg.family in ("dense", "vlm"):
        return {"k": kvax, "v": kvax, "pos": ()}
    if cfg.family == "moe":
        c = {"k": kvax, "v": kvax, "pos": ()}
        if cfg.first_k_dense:
            c["dk"] = kvax
            c["dv"] = kvax
        return c
    if cfg.family == "ssm":
        return {"wkv": ("layers", "batch", "heads", None, None),
                "tm": ("layers", "batch", "d_model"),
                "cm": ("layers", "batch", "d_model"),
                "pos": ()}
    if cfg.family == "hybrid":
        return {"k": ("layers", "batch", None, "kv_heads", None),
                "v": ("layers", "batch", None, "kv_heads", None),
                "conv": ("layers", "batch", None, "heads"),
                "h": ("layers", "batch", "heads", None),
                "pos": ()}
    if cfg.family == "encdec":
        return {"k": kvax, "v": kvax,
                "xk": ("layers", "batch", None, "kv_heads", None),
                "xv": ("layers", "batch", None, "kv_heads", None),
                "pos": ()}
    raise ValueError(cfg.family)


# ===========================================================================
# build_model
# ===========================================================================

def build_model(cfg: ModelConfig) -> Model:
    """Assemble a `Model` for one config of any family — dense, moe, ssm
    (rwkv6), hybrid, encdec (whisper) or vlm (internvl2): init_params /
    loss_fn / prefill / decode_step / prefill_into_slot / init_cache, in
    the JAX package's layouts; loss_fn trains every one of them (hybrid
    with ssm_impl="pallas" raises in the backward: the scan kernel has
    none). Whisper's batches carry "frames" (B, enc_seq, D), internvl2's
    "vis" (B, n_vis_tokens, D), beside "tokens".

    Example::

        import torch, repro_torch
        cfg = repro_torch.get_config("qwen2-1.5b")          # full width
        model = repro_torch.build_model(cfg)
        params = model.init_params(0)                       # on the card
        logits, cache = model.prefill(params, {"tokens": torch.ones(
            (1, 8), dtype=torch.long, device="cuda")})
    """
    param_fn = T.build_param_fn(cfg)
    shapes = ParamInit(abstract=True)
    param_fn(shapes)

    def abstract_params() -> Dict:
        return param_fn(ParamInit(abstract=True))

    def init_params(seed: int = 0, device=backend.DEFAULT_DEVICE) -> Dict:
        """Random params from `seed` (N(0,1) x 0.02 and ones, as the JAX
        ParamBuilder; other values than jax.random's) on `device`."""
        return param_fn(ParamInit(seed, backend.resolve_device(device)))

    def _final_norm(params, x):
        if cfg.family == "encdec":
            return layer_norm(x, params["final_norm"], params["final_normb"],
                              cfg.norm_eps)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def _vocab_tp(ctx, rows):
        """The model group where the training plan splits the vocab of a
        table or head with `rows` of it (the serving steps of
        train/step.py over a model axis); None under exact-TP (the
        engine) or where the vocab is whole."""
        if ctx is None or in_exact_tp():
            return None
        return ctx.row_parallel(rows, cfg.vocab_size)

    def _logits(params, x, ctx=None):
        x = _final_norm(params, x)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        tp = _vocab_tp(ctx, head.shape[-1])
        if tp is not None:
            # the training plan's vocab-split head: this rank's columns,
            # all-gathered whole
            return tp.all_gather(lm_logits(x, head), x.dim() - 1)
        if cfg.tie_embeddings:
            # the tied table is replicated under exact-TP: already whole
            return lm_logits(x, params["embed"].T)
        # under exact-TP an untied head gives this rank's vocab columns,
        # K-blocked so they keep the whole head's bits, gathered whole. An
        # odd vocab (hymba, whisper, internvl2) splits over no even model
        # axis: serve_specs replicates the head, every rank computes it
        # whole, and one product keeps the unsharded engine's bits
        head_split = in_exact_tp() and cfg.vocab_size % 2 == 0
        return gather_exact_tp(lm_logits(x, params["head"],
                                         blocked=head_split),
                               cfg.vocab_size)

    def _prefixed_embed(params, batch, tp=None):
        """The first layer's input: whisper's decoder embeddings plus its
        learned positions (added in bf16); internvl2's patch embeddings,
        cast to bf16, before the text's; the token embeddings else (tp:
        the model group of a vocab-parallel table, `layers.embed`)."""
        x = embed(batch["tokens"], params["embed"], tp)
        if cfg.family == "encdec":
            return x + params["dec_pos"][:x.shape[1]][None].to(x.dtype)
        if cfg.family == "vlm":
            x = torch.cat([batch["vis"].to(x.dtype), x], dim=1)
        return x

    @backend.f32_accumulation()
    def loss_fn(params, batch, ctx: Optional[DistCtx] = None):
        """(total, {"loss", "aux", "ntokens"}) of batch["tokens"] (B, S)
        against batch["labels"] (B, S): the mean over labels >= 0 of the
        cross-entropy with z-loss 1e-4, all f32 scalars; total adds
        router_aux_coef x aux, the moe layers' summed router aux loss (0
        for every other family). Whisper's batch also carries "frames",
        internvl2's "vis" (prepended; the loss is taken on the text
        positions only). The xent runs in sequence chunks (512, 256, 128
        or 64, the largest that divides S and is below it), each under its
        own checkpoint, so one (B, chunk, V) f32 logits block is live at a
        time.

        With a ctx over data axes of n > 1 ranks the batch is this rank's
        rows of the global batch and the values are this rank's SHARES of
        the global batch's: loss is its rows' sum over labels >= 0 divided
        by the global count (all-reduced first; ntokens is that count),
        aux its share of the global router aux (`_moe_apply`), so every
        value but ntokens sums over the ranks to the reference's value on
        the global batch, and so do the grads of total.

        With a ctx whose model axis the training plan splits the heads,
        the channels and d_ff over (every family): every layer is
        row-parallel (`_dense_stack`, `_hymba_stack`, `_rwkv_train_stack`,
        whisper's encoder and decoder), and where the plan splits the
        vocab too the embedding is vocab-parallel and each chunk's head
        gives this rank's vocab columns of the logits (the tied table's
        rows are the same shard), whose cross-entropy is vocab-parallel
        (`layers.softmax_xent`'s tp); an odd vocab's table and head are
        whole on every rank. The vlm prefix enters whole on every rank.
        The chunks' remat recomputes their collectives in the backward.
        Every rank of the model group computes the same values; ntokens
        counts over the data axes only."""
        vocab_tp = None if ctx is None else ctx.row_parallel(
            params["embed"].shape[0], cfg.vocab_size)
        x = _prefixed_embed(params, batch, vocab_tp)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "encdec":
            enc_out = _whisper_encode(cfg, params, batch["frames"],
                                      remat=cfg.remat, ctx=ctx)
            x = _whisper_train_stack(cfg, params["dec_layers"], x, enc_out,
                                     remat=cfg.remat, ctx=ctx)
        elif cfg.family == "ssm":
            x = _rwkv_train_stack(cfg, params["layers"], x, remat=cfg.remat,
                                  ctx=ctx)
        elif cfg.family == "hybrid":
            x = _hymba_stack(cfg, params["layers"], x, positions,
                             remat=cfg.remat, ctx=ctx)
        else:
            if "dense_layers" in params:
                x, _ = _dense_stack(cfg, params["dense_layers"], x,
                                    positions, remat=cfg.remat, ctx=ctx)
            x, aux = _dense_stack(cfg, params["layers"], x, positions,
                                  remat=cfg.remat, ctx=ctx)
        if cfg.family == "vlm":
            x = x[:, batch["vis"].shape[1]:]
        labels = batch["labels"]
        s = x.shape[1]
        chunk = s
        for c in (512, 256, 128, 64):
            if s % c == 0 and s > c:
                chunk = c
                break

        head = params["embed"].T if cfg.tie_embeddings else params.get(
            "head")
        head_tp = None if ctx is None or head is None else ctx.row_parallel(
            head.shape[-1], cfg.vocab_size)

        def xent_chunk(x_c, labels_c):
            if head_tp is None:
                logits = _logits(params, x_c)
            else:
                # this rank's vocab columns of the head (a column-parallel
                # product of the whole stream: CopyToGroup)
                logits = lm_logits(copy_to(_final_norm(params, x_c),
                                           head_tp), head)
            mask = (labels_c >= 0).float()
            per_tok = softmax_xent(logits, torch.clamp_min(labels_c, 0),
                                   tp=head_tp)
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
        if ctx is not None and ctx.data_size > 1:
            msum = ctx.data_group().all_reduce(msum)    # the global count
        ntok = torch.clamp_min(msum, 1.0)
        loss = lsum / ntok
        total = loss + cfg.router_aux_coef * aux
        return total, {"loss": loss, "aux": aux, "ntokens": ntok}

    @backend.f32_accumulation()
    @torch.no_grad()
    def prefill(params, batch, ctx: Optional[DistCtx] = None, *,
                last_index=None):
        """Full forward; returns (last-token logits (B,1,V) f32, cache).

        batch["tokens"]: (B, S) int. batch may carry "pad_lens" — a (B,)
        count of LEFT pad tokens per row: positions then start at 0 on each
        row's first real token and pad key/value columns are masked out of
        every softmax. last_index: optional index into the sequence axis
        (int or 0-d tensor); the logits are taken there instead of at -1
        (prefill_into_slot: a right-padded row's last real token).

        Moe: pad tokens get router weight 0 and claim no expert capacity,
        but the capacity stays derived from the padded token count (the
        JAX package's caveat). Ssm and hybrid: pad_lens raises ValueError
        (the recurrent state would consume the pads). Hybrid: the cache's
        k/v hold the last min(S, attn_window) positions in the ring layout.
        Ssm: the cache holds the wkv states and last inputs of a segment
        started from zero states (wkv6_chunked at chunk 64 when S % 64 ==
        0, one chunk when S < 64, else the sequential scan). Encdec: batch
        also carries "frames" (B, enc_seq, D); the encoder runs, and the
        cache holds the decoder's k/v and the cross-attention's xk/xv.
        Vlm: batch also carries "vis" (B, n_vis_tokens, D), prepended, so
        S and last_index count its lines. Ssm, hybrid, encdec and vlm:
        pad_lens raises ValueError."""
        pad_lens = batch.get("pad_lens")
        if pad_lens is not None and cfg.family not in ("dense", "moe"):
            raise ValueError(
                "pad_lens (left-padded prefill) is only defined for pure "
                "attention stacks (the dense and moe families): the "
                "recurrent state of ssm and hybrid would consume the pads, "
                "and vlm and encdec prepend non-text tokens (the vis "
                "prefix, the encoder's frames); family "
                f"{cfg.family!r}")
        x = _prefixed_embed(params, batch,
                            _vocab_tp(ctx, params["embed"].shape[0]))
        s = x.shape[1]
        dev = x.device
        if pad_lens is None:
            positions = torch.arange(s, device=dev)
            kv_valid = None
        else:
            pad_lens = torch.as_tensor(pad_lens, device=dev)
            ar = torch.arange(s, device=dev)[None, :]
            positions = torch.clamp_min(ar - pad_lens[:, None], 0)
            kv_valid = ar >= pad_lens[:, None]
        if cfg.family == "encdec":
            enc_out = _whisper_encode(cfg, params, batch["frames"], ctx=ctx)
            x, cache = _whisper_prefill_stack(cfg, params["dec_layers"], x,
                                              enc_out, ctx)
        elif cfg.family == "hybrid":
            x, cache = _hymba_prefill_stack(cfg, params["layers"], x,
                                            positions, ctx)
        elif cfg.family == "ssm":
            x, cache = _rwkv_prefill_stack(cfg, params["layers"], x, ctx)
        else:
            cache = {}
            if "dense_layers" in params:       # moe: the first_k_dense
                x, dk, dv = _dense_prefill_stack(
                    cfg, params["dense_layers"], x, positions,
                    kv_valid=kv_valid, ctx=ctx)
                cache.update(dk=dk, dv=dv)
            x, ks, vs = _dense_prefill_stack(cfg, params["layers"], x,
                                             positions, kv_valid=kv_valid,
                                             ctx=ctx)
            cache.update(k=ks, v=vs)
        cache["pos"] = torch.tensor(s, dtype=torch.int32, device=dev)
        if last_index is None:
            last = x[:, -1:]
        else:
            idx = torch.as_tensor(last_index, device=dev).long().reshape(1)
            last = x.index_select(1, idx)
        return _logits(params, last, ctx), cache

    @backend.f32_accumulation()
    @torch.no_grad()
    def decode_step(params, cache: Cache, tokens,
                    ctx: Optional[DistCtx] = None):
        """tokens: (B, 1). Returns (logits (B,1,V) f32, cache): k/v (the
        moe family's dk/dv, the hybrid family's conv and h; the ssm
        family's wkv, tm and cm instead) are written in place, "pos" (a
        scalar or a (B,) per-row vector) advances by one in a new tensor.
        A moe layer routes all B rows, idle slots included, as the JAX
        engine's decode does. Encdec: the learned position of each row's
        pos is added to its embedding (in bf16), and xk/xv are read, not
        written. Over a model axis of the training plan (the decode step
        of train/step.py) every layer is row-parallel, the embedding and
        head vocab-parallel, and the logits gathered whole."""
        x = embed(tokens, params["embed"],
                  _vocab_tp(ctx, params["embed"].shape[0]))
        if cfg.family == "encdec":
            # index_select keeps the shapes static (no read of pos: the
            # census runs this on fake tensors)
            pos = cache["pos"].long()
            pe = params["dec_pos"].index_select(0, pos.reshape(-1)).to(
                x.dtype)
            x = x + (pe[:, None] if pos.dim() == 1 else pe[None])
            x, cache = _whisper_decode_stack(cfg, params["dec_layers"], x,
                                             cache, ctx)
        elif cfg.family == "hybrid":
            x, cache = _hymba_decode_stack(cfg, params["layers"], x, cache,
                                           ctx)
        elif cfg.family == "ssm":
            x, cache = _rwkv_decode_stack(cfg, params["layers"], x, cache,
                                          ctx)
        else:
            if "dense_layers" in params:
                x, _ = _dense_decode_stack(
                    cfg, params["dense_layers"], x,
                    {"k": cache["dk"], "v": cache["dv"], "pos": cache["pos"]},
                    ctx=ctx)
            x, cache = _dense_decode_stack(cfg, params["layers"], x, cache,
                                           ctx=ctx)
        return _logits(params, x, ctx), cache

    @backend.f32_accumulation()
    @torch.no_grad()
    def decode_verify(params, cache: Cache, tokens):
        """tokens: (B, Q) — per row, the last committed token followed by
        Q-1 draft candidates. Returns (logits (B,Q,V) f32, cache):
        logits[:, j] is the target distribution AFTER consuming
        tokens[:, j], what Q sequential decode_step calls would give.

        cache["pos"] must be the (B,) per-row slot-scheduler layout; row
        writes land at pos..pos+Q-1 in place (a line past the cache end is
        dropped) and "pos" advances by Q (the speculated tip) in a new
        tensor. The caller rolls pos back to the last ACCEPTED line after
        the accept decision (serve/spec.py)."""
        x = embed(tokens, params["embed"])
        pos = cache["pos"]
        for i in range(params["layers"]["ln1"].shape[0]):
            lp = _layer(params["layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _ = T.attn_block_decode_k(lp["attn"], h, cfg,
                                         cache_k=cache["k"][i],
                                         cache_v=cache["v"][i], pos=pos)
            x = x + a
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + swiglu(h, lp["ffn"]["wi"], lp["ffn"]["wg"],
                           lp["ffn"]["wo"])
        return _logits(params, x), {**cache, "pos": pos + tokens.shape[1]}

    @backend.f32_accumulation()
    @torch.no_grad()
    def prefill_into_slot(params, cache: Cache, slot, batch, prompt_len,
                          ctx: Optional[DistCtx] = None):
        """Prefill ONE request (batch row of size 1) and overwrite `slot`'s
        cache lines in a batched decode cache whose "pos" is a (B,) per-row
        vector. batch["tokens"] is (1, P); P may exceed the real prompt
        (right padding to a shape bucket): pad lines land beyond
        prompt_len, stay masked by the per-row length, and are overwritten
        as decode advances. For the ssm and hybrid families (recurrent
        state folds every token in) and the moe family (capacity dispatch
        counts the tokens) P must equal the real prompt length. Logits are
        taken at prompt_len - 1. Vlm: prompt_len counts the n_vis_tokens
        lines before the text; encdec and vlm: batch also carries the
        row's "frames" or "vis".

        Returns (logits (1,1,V), cache): row `slot` of every cache leaf
        but "pos" is written in place from the row's prefill cache, its
        leading lines along the third axis (the JAX dynamic_update_slice
        at (0, slot, 0, ...) of each leaf: P k/v lines (n_vis_tokens + P
        for vlm), min(P, window) of them for the hybrid ring, the whole
        conv tail and h state, the whole wkv state and tm/cm rows of the
        ssm family, all enc_seq xk/xv lines of encdec), and
        pos[slot] = prompt_len in a new "pos" tensor."""
        plen = torch.as_tensor(prompt_len, device=cache["pos"].device)
        logits, row = prefill(params, batch, ctx, last_index=plen - 1)
        for key, full in cache.items():
            if key != "pos":
                part = row[key][:, 0]
                full[:, slot, :part.shape[1]] = part.to(full.dtype)
        pos = cache["pos"].clone()
        pos[slot] = plen.to(pos.dtype)
        return logits, {**cache, "pos": pos}

    @backend.f32_accumulation()
    @torch.no_grad()
    def prefill_continue(params, cache: Cache, slot, batch, start, n_real):
        """Prefill ONLY the unseen suffix of a request whose first `start`
        prompt positions already sit in `slot`'s cache rows (restored
        prefix pages). batch["tokens"]: (1, S) suffix tokens, right-padded
        to a shape bucket (pad lines land past the real suffix and stay
        masked by the row's pos). n_real: the real suffix length; logits
        are taken at suffix index n_real - 1.

        Returns (logits (1,1,V), cache): row `slot` of k/v written in
        place at start..start+S, pos[slot] = start + n_real in a new "pos"
        tensor."""
        x = embed(batch["tokens"], params["embed"])
        positions = start + torch.arange(x.shape[1], device=x.device)
        for i in range(params["layers"]["ln1"].shape[0]):
            lp = _layer(params["layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _ = T.attn_block_continue(
                lp["attn"], h, cfg, cache_k=cache["k"][i],
                cache_v=cache["v"][i], slot=slot, start=start,
                positions=positions)
            x = x + a
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + swiglu(h, lp["ffn"]["wi"], lp["ffn"]["wg"],
                           lp["ffn"]["wo"])
        pos = cache["pos"].clone()
        pos[slot] = start + n_real
        return (_logits(params, x[:, n_real - 1:n_real]),
                {**cache, "pos": pos})

    return Model(cfg=cfg, init_params=init_params, loss_fn=loss_fn,
                 prefill=prefill,
                 decode_step=decode_step, prefill_into_slot=prefill_into_slot,
                 init_cache=functools.partial(make_cache, cfg),
                 prefill_continue=(prefill_continue if cfg.family == "dense"
                                   else None),
                 decode_verify=(decode_verify if cfg.family == "dense"
                                else None),
                 param_axes=shapes.axes, param_parts=shapes.parts,
                 cache_axes=functools.partial(cache_logical_axes, cfg),
                 abstract_params=abstract_params)
