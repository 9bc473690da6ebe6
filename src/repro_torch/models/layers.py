"""Shared model building blocks — the port of `repro.models.layers`
(numerics, rotary embedding, embedding/head, the cross-entropy, parameter
init).

Conventions, as in the JAX package:
  * params are nested dicts of tensors whose keys are the JAX tree's
    paths; layer stacks keep their leading "layers" axis and the model
    loops over it in Python (the JAX `lax.scan`);
  * matmuls take bf16 operands with an f32 accumulator and cast the result
    back to bf16; norms, rope and softmax run in f32.

`matmul` on a card is `torch.matmul` in bf16 (cuBLAS accumulates in f32;
the caller disables reduced-precision bf16 reductions, as chip_smoke.py
does); on the CPU it multiplies in f32 and casts once, so the CPU tests
see exactly one rounding as XLA's dot_general with
preferred_element_type=f32 does. An f32 activation (whisper's encoder
stream when its frames are f32) meets the bf16-valued weight in an f32
product on either device, as JAX promotes the pair, and the result is
rounded once.

Exact tensor parallelism (`exact_tp_scope`, `gather_exact_tp`,
`matmul_rp`, `DistCtx`): one process a mesh rank, each holding its local
shards (dist/sharding.serve_specs: weights split on their output dims
only). Inside the scope a row-parallel projection all-gathers its
activation over the mesh's "model" group in rank order before it
contracts against the whole (replicated) weight, so every float
reduction keeps the one-device order and a sharded engine is bit-equal
to the unsharded one. A column shard of a product must then equal the
same columns of the whole product: on the CPU, inside the scope, a
contraction runs in power-of-two K blocks of at most K_BLOCK, added in
order (`_blocked_product`: MKL's own order for other K depends on N),
and so does an untied head's (`lm_logits(blocked=True)`: cuBLAS's
one-row f32 product orders K by N on the card too); on the card a
column-parallel projection whose block's own product is observed to
differ from the whole's columns (cuBLAS picks a kernel by the shape;
tools/tp_exactness_probe.py) computes the rank's columns inside the
whole width's product, zeros at the other ranks' columns
(`_column_product`; the rank's column-split weights are recorded once
from the serve specs, dist/sharding.column_blocks, and handed to the
scope), as mamba's f32 dt projection may on either device
(`matmul_f32`). The unsharded engine runs in the scope with no
mesh, so it keeps the same order; everything else (training) contracts
in one product.

Tensor-parallel training (the reference's training plan over a model
axis: wo's rows, d_ff and the vocab split, so products sum partials):
`matmul_rp(tp=)` (a row-parallel product's partials summed),
`swiglu(tp=)`, `gelu_ffn(tp=)`, `embed(tp=)` (vocab-parallel) and
`softmax_xent(tp=)` (vocab-parallel, z-loss on the whole vocab's
logsumexp) take the model group (`DistCtx.row_parallel`,
`DistCtx.model_group`) and sum over it with dist.collectives.CopyToGroup
/ ReduceFromGroup; exact_tp_scope stays off in training.

The whisper pieces: `layer_norm` (f32 statistics, population variance),
`gelu_ffn` (bias adds in bf16, the tanh gelu of `jax.nn.gelu`'s default
in f32) and `sinusoid_pos` (f32, rounded once to bf16).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.dist.collectives import copy_to, reduce_from

PARAM_DTYPE = torch.bfloat16
NORM_DTYPE = torch.float32
# the largest contraction block of _blocked_product
K_BLOCK = 256

Axes = Tuple[Optional[str], ...]


class ParamInit:
    """Creates parameters in the JAX ParamBuilder's order, from one
    explicit `torch.Generator`, and records each one's shape and logical
    axes (the sharding engine's input, dist/sharding.py): "normal" is
    N(0, 1) x scale drawn in f32 and cast; "ones"/"zeros", "const:<v>" and
    "a_log" (log(1..N) along the last axis, the mamba A init) are
    constants that draw nothing. The values differ from jax.random's;
    tests carry the JAX weights across with models.convert.params_from_numpy
    instead. abstract=True allocates nothing: every leaf is an empty tensor
    on the "meta" device (shapes and dtypes only).

        init = ParamInit(seed=0, device="cuda")
        w = init.param("layers/attn/wq", (L, D, H * Hd),
                       ("layers", "d_model", "heads"))
    `init.shapes` and `init.axes` afterwards map path -> shape, axes;
    `init.parts` maps the path of a leaf whose last dim packs several
    tensors side by side (parts=, e.g. mamba's in_proj: xs | z) to their
    count, which a rank's shard of it keeps (dist/sharding.local_shard).
    """

    def __init__(self, seed: int = 0, device=None, scale: float = 0.02, *,
                 abstract: bool = False):
        if device is None and not abstract:
            raise ValueError("ParamInit needs a device (or abstract=True)")
        self.abstract = abstract
        self.device = torch.device("meta" if abstract else device)
        self.gen = (None if abstract else
                    torch.Generator(device=self.device).manual_seed(seed))
        self.scale = scale
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.axes: Dict[str, Axes] = {}
        self.parts: Dict[str, int] = {}

    def param(self, path: str, shape: Tuple[int, ...], axes: Axes,
              init: str = "normal", dtype=PARAM_DTYPE, *,
              parts: int = 1) -> torch.Tensor:
        assert len(shape) == len(axes), (path, shape, axes)
        self.shapes[path] = tuple(shape)
        self.axes[path] = tuple(axes)
        if parts > 1:
            self.parts[path] = parts
        if self.abstract:
            return torch.empty(shape, dtype=dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "normal":
            w = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                            device=self.device)
            # scaled in place: one f32 transient (a moe expert stack at
            # full width is ~20 GB in f32)
            return w.mul_(self.scale).to(dtype)
        if init == "a_log":  # mamba: A = -arange(1..N) broadcast over channels
            row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                         device=self.device))
            return row.to(dtype).expand(shape).contiguous()
        if init.startswith("const:"):
            return torch.full(shape, float(init.split(":")[1]), dtype=dtype,
                              device=self.device)
        raise ValueError(init)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def _k_blocks(k: int):
    """K split into power-of-two blocks of at most K_BLOCK, largest first:
    1536 -> 256 x 6, 384 -> 256 + 128, 192 -> 128 + 64."""
    k0 = 0
    while k0 < k:
        kb = min(K_BLOCK, 1 << ((k - k0).bit_length() - 1))
        yield k0, kb
        k0 += kb


def _blocked_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in f32, contracted in power-of-two K blocks of at most K_BLOCK
    (`_k_blocks`), added in order. A BLAS's own order of a long K may
    depend on N: MKL's at a K of 384 or of 1024 and more, cuBLAS's one-row
    f32 product at deepseek's head (tools/tp_exactness_probe.py); a half-
    or quarter-width column block of the product then differs from the
    same columns of the whole product in the last f32 bits. Each short
    block's product is the same whatever N (tests/test_torch_serve_tp.py
    on the CPU, the probe on the card), so a column shard is bit-equal to
    its columns of the whole product (exact-TP)."""
    out = None
    for k0, kb in _k_blocks(x.shape[-1]):
        part = torch.matmul(x[..., k0:k0 + kb].float(),
                            w.narrow(-2, k0, kb).float())
        out = part if out is None else out + part
    return out


def _own_columns(product, w: torch.Tensor, whole: int, parts: int,
                 block: int) -> torch.Tensor:
    """product(w) where w is the `block`-th column block of a weight `whole`
    columns wide (each of `parts` packed tensors split alike): the product
    runs at the whole width with w's columns at their place and zeros at
    the other blocks', and w's columns come back out. It is then the
    one-device call, whose bits a column block keeps whatever the
    library's choice of kernel for that width (the rule of
    attention._f32_heads, for columns)."""
    n = w.shape[-1] // parts
    span = whole // parts
    first = block * n
    wp = torch.nn.functional.pad(w.unflatten(-1, (parts, n)),
                                 (first, span - first - n)).flatten(-2)
    out = product(wp)
    return out.unflatten(-1, (parts, span)).narrow(-1, first, n).flatten(-2)


# (x's shape, w's shape, whole, parts, block, dtypes, device type) ->
# whether a rank's column block must run inside the whole width's product
_WHOLE_WIDTH: Dict[tuple, bool] = {}


def whole_width_picks() -> Dict[tuple, bool]:
    """The column-parallel product shapes seen in this process inside
    exact_tp_scope, each with whether it runs at the whole width."""
    return dict(_WHOLE_WIDTH)


def _column_product(product, x: torch.Tensor, w: torch.Tensor, whole: int,
                    parts: int, block: int) -> torch.Tensor:
    """product(x, w), w this rank's column block of a weight `whole`
    columns wide (a column-parallel projection under exact-TP,
    `exact_tp_scope(columns=)`). The library picks its kernel, at a small
    M also its split of K, by the shape, so a block's own product may
    differ from the same columns of the whole width's product
    (tools/tp_exactness_probe.py --families: on the card rwkv6-7b's wr
    and internvl2-26b's wq at M = 4 in bf16, hymba's f32 dt product,
    whisper's f32 encoder products). Whether it does depends on the
    shapes and dtypes alone: the first call of a shape compares the two
    on seeded random operands and keeps the answer, and only a shape
    where they differ runs inside the whole width's product
    (`_own_columns`)."""
    key = (tuple(x.shape), tuple(w.shape), whole, parts, block, x.dtype,
           w.dtype, x.device.type)
    need = _WHOLE_WIDTH.get(key)
    if need is None:
        g = torch.Generator(device=x.device).manual_seed(0)
        xr = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
        wr = torch.randn(w.shape, generator=g, device=w.device).to(w.dtype)
        need = _WHOLE_WIDTH[key] = not torch.equal(
            product(xr, wr), _own_columns(lambda wp: product(xr, wp), wr,
                                          whole, parts, block))
    if need:
        return _own_columns(lambda wp: product(x, wp), w, whole, parts,
                            block)
    return product(x, w)


def _column_of(w: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(whole, parts, block) where w is (a layer's slice of) this rank's
    column block of a weight, inside exact_tp_scope(columns=); else None.
    A layer's slice shares its stacked leaf's storage, whose address keys
    the record (dist/sharding.column_blocks)."""
    if not _EXACT_TP_COLUMNS:
        return None
    return _EXACT_TP_COLUMNS.get(w.untyped_storage().data_ptr())


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in f32 (both operands cast), the result f32: one product; a
    rank's column block (mamba's dt projection on a rank's channels)
    through `_column_product` on either device."""
    cols = _column_of(w)
    if cols is not None:
        return _column_product(_f32_product, x, w, *cols)
    return _f32_product(x, w)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32 accumulate -> bf16, contracting x's last axis
    with w's first. An f32 x against a bf16 w (whisper's encoder stream on
    f32 frames) is multiplied in f32 and the result rounded once to
    PARAM_DTYPE; on the card any other pair of types raises. On the card a
    rank's column block goes through `_column_product`; on the CPU the
    K-blocked product keeps a block's bits as it is."""
    if x.is_cuda:
        cols = _column_of(w)
        if cols is not None:
            return _column_product(_matmul, x, w, *cols)
    return _matmul(x, w)


# while set (card_products), CPU tensors take the card's route through
# _matmul: analyze.census.census_step counts the bf16 products a card
# runs, on fake CPU tensors
_CARD_PRODUCTS = False


@contextlib.contextmanager
def card_products():
    """While open, `matmul` multiplies CPU tensors as it does on the card
    (a bf16 pair in bf16, no f32 widening): the census of a step on fake
    CPU tensors (analyze.census.census_step) counts the card's products,
    their tensor-core FLOPs and bytes. Nothing it computes is read."""
    global _CARD_PRODUCTS
    saved, _CARD_PRODUCTS = _CARD_PRODUCTS, True
    try:
        yield
    finally:
        _CARD_PRODUCTS = saved


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.is_cuda or _CARD_PRODUCTS:
        if x.dtype == w.dtype:
            return torch.matmul(x, w)
        if x.dtype != torch.float32 or w.dtype != torch.bfloat16:
            raise TypeError(f"matmul of {x.dtype} by {w.dtype}: only an f32 "
                            f"activation may meet a bf16 weight")
    elif _EXACT_TP_ON:
        return _blocked_product(x, w).to(PARAM_DTYPE)
    return torch.matmul(x.float(), w.float()).to(PARAM_DTYPE)


# --- exact-TP (bit-exact sharded serving) ----------------------------------
# Set by ServeEngine around every model call:
# inside the scope the row-parallel projections all-gather their
# activation over the mesh's "model" group before they contract, instead
# of summing per-rank partials (a sum in rank order moves the result by
# ~1 bf16 ulp, enough to flip an argmax). With the serve plan's
# column-parallel-only weights every float reduction then runs in the
# one-device order.
_EXACT_TP_ON = False
_EXACT_TP_MESH = None
# this rank's column-split weights: storage address -> (whole, parts, block)
_EXACT_TP_COLUMNS: Dict[int, Tuple[int, int, int]] = {}
# the scope's gathers, for the checks: calls and bytes gathered (the whole
# tensors' bytes); tp_counts() reads them, reset_tp_counts() zeroes them
_TP_COUNTS = {"gathers": 0, "bytes": 0}


class exact_tp_scope:
    """Context manager marking model calls as exact-TP over `mesh`. With
    mesh None the calls run on one device in the sharded engine's order
    (the K-blocked CPU products and untied head): the unsharded engine
    that a sharded one is held to bit for bit. columns: the rank's
    column-split weights (dist/sharding.column_blocks), whose products
    keep the whole product's columns (`_column_product`)."""

    def __init__(self, mesh, columns: Optional[Dict] = None):
        self.mesh = mesh
        self.columns = columns or {}

    def __enter__(self):
        global _EXACT_TP_ON, _EXACT_TP_MESH, _EXACT_TP_COLUMNS
        self._prev = _EXACT_TP_ON, _EXACT_TP_MESH, _EXACT_TP_COLUMNS
        _EXACT_TP_ON, _EXACT_TP_MESH = True, self.mesh
        _EXACT_TP_COLUMNS = self.columns
        return self

    def __exit__(self, *exc):
        global _EXACT_TP_ON, _EXACT_TP_MESH, _EXACT_TP_COLUMNS
        _EXACT_TP_ON, _EXACT_TP_MESH, _EXACT_TP_COLUMNS = self._prev
        return False


def in_exact_tp() -> bool:
    """Whether a model call runs inside exact_tp_scope (with or without a
    mesh)."""
    return _EXACT_TP_ON


def exact_tp_size() -> int:
    """The model axis's size inside exact_tp_scope, 1 outside it."""
    if _EXACT_TP_MESH is None:
        return 1
    return int(_EXACT_TP_MESH.shape.get("model", 1))


def tp_counts() -> Dict[str, int]:
    return dict(_TP_COUNTS)


def reset_tp_counts() -> None:
    _TP_COUNTS.update(gathers=0, bytes=0)


def gather_exact_tp(x: torch.Tensor, width: Optional[int] = None
                    ) -> torch.Tensor:
    """Inside exact_tp_scope: x's last dim all-gathered over the mesh's
    "model" group and concatenated in rank order (the exact-TP combine),
    unless x already has `width` columns (a dim the plan left whole).
    Outside the scope, or on a model axis of 1: x itself."""
    tp = exact_tp_size()
    if tp == 1 or (width is not None and x.shape[-1] == width):
        return x
    if width is not None and x.shape[-1] * tp != width:
        raise ValueError(f"gather_exact_tp: {x.shape[-1]} columns a rank x "
                         f"{tp} ranks != {width}")
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp)]
    dist.all_gather(parts, x, group=_EXACT_TP_MESH.group("model"))
    out = torch.cat(parts, dim=-1)
    _TP_COUNTS["gathers"] += 1
    _TP_COUNTS["bytes"] += out.numel() * out.element_size()
    return out


def matmul_rp(x: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """Row-parallel projection: x's last dim is the contraction, whole in
    w (the serve plan never shards a contraction dim). Inside
    exact_tp_scope a column-sharded x is gathered first, so the product
    is computed whole on every rank: bit-equal to one device, no sum
    across ranks. The JAX package's bf16-result dot is `matmul`'s single
    rounding here. tp: the model group where the training plan splits
    w's rows over it (x this rank's block of the contraction): the
    partial product is summed over the group (ReduceFromGroup)."""
    if tp is not None:
        return reduce_from(matmul(x, w), tp)
    return matmul(gather_exact_tp(x, w.shape[-2]), w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(NORM_DTYPE)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(NORM_DTYPE)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics (the population variance, as jnp.var);
    returns x's dtype."""
    xf = x.to(NORM_DTYPE)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(NORM_DTYPE) + bias.to(NORM_DTYPE)).to(x.dtype)


def swiglu(x, wi, wg, wo, tp=None):
    """SwiGLU FFN: silu(x@wg) * (x@wi) @ wo. tp: the model group where the
    plan splits d_ff over it (tensor-parallel training: wi/wg this rank's
    columns, wo its rows): x enters through CopyToGroup and the partial
    product leaves through ReduceFromGroup (`matmul_rp`'s tp)."""
    x = copy_to(x, tp)
    h = matmul(x, wi)
    g = matmul(x, wg)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return matmul_rp(h, wo, tp)


def gelu_ffn(x, wi, bi, wo, bo, tp=None):
    """Whisper's FFN: gelu(x@wi + bi) @ wo + bo, the bias adds rounded in
    bf16 and the gelu the tanh form (jax.nn.gelu's default) in f32. tp:
    as swiglu's (bi this rank's d_ff columns); bo is added once, to the
    sum."""
    x = copy_to(x, tp)
    h = matmul(x, wi) + bi.to(PARAM_DTYPE)
    h = torch.nn.functional.gelu(h.float(), approximate="tanh").to(
        PARAM_DTYPE)
    return matmul_rp(h, wo, tp) + bo.to(PARAM_DTYPE)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, Hd); positions: (S,) or broadcastable (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (Hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., S, Hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def sinusoid_pos(seq: int, d: int, offset: int = 0, device=None
                 ) -> torch.Tensor:
    """(seq, d) sinusoidal positions from `offset`: the sines of the d/2
    frequencies, then their cosines, computed in f32 and rounded once to
    PARAM_DTYPE."""
    pos = torch.arange(offset, offset + seq, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    log_base = torch.log(torch.tensor(10000.0, device=device))
    inv = torch.exp(-log_base * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(PARAM_DTYPE)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor, tp=None
          ) -> torch.Tensor:
    """table[tokens]. tp: the model group where the plan splits the vocab
    over it (a vocab-parallel embedding: this rank holds rows [r V/tp,
    (r + 1) V/tp)): a rank looks up the tokens its rows hold, zeros for the
    others, and the ranks' lookups are summed (ReduceFromGroup: one value
    and zeros, exact)."""
    if tp is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens.long() - tp.index * rows
    mine = (local >= 0) & (local < rows)
    e = table[local.clamp(0, rows - 1)]
    return reduce_from(torch.where(mine[..., None], e, torch.zeros(
        (), dtype=e.dtype, device=e.device)), tp)


def lm_logits(x: torch.Tensor, table_or_head: torch.Tensor, *,
              blocked: bool = False) -> torch.Tensor:
    """Project to the vocabulary in f32: bf16 operands, whose products are
    exact in f32, multiplied and summed in f32. blocked=True contracts in
    K blocks (`_blocked_product`), so a vocab shard's logits are
    bit-equal to the same columns of the whole head's (exact-TP's untied
    head)."""
    if blocked:
        return _blocked_product(x, table_or_head)
    return torch.matmul(x.float(), table_or_head.float())


def softmax_xent(logits_f32: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 1e-4, tp=None) -> torch.Tensor:
    """Cross-entropy with the PaLM-style z-loss: lse - ll + z_loss * lse^2
    per token. logits: (..., V) f32; labels: (...) int (each in [0, V)).

    tp: the model group where the logits are this rank's vocab columns
    [r V/tp, (r + 1) V/tp) (a vocab-parallel head): the max (no gradient),
    the sum of exponentials and the target logit (one rank's value and
    zeros) are summed over the group (ReduceFromGroup), so lse, the loss
    and its z term are the whole vocab's on every rank, and the logits'
    grad is this rank's columns of softmax minus one-hot."""
    if tp is None:
        lse = torch.logsumexp(logits_f32, dim=-1)
        ll = torch.gather(logits_f32, -1, labels.long()[..., None])[..., 0]
    else:
        cols = logits_f32.shape[-1]
        m = tp.all_reduce(logits_f32.detach().amax(-1), op="max")
        se = torch.exp(logits_f32 - m[..., None]).sum(-1)
        lse = m + torch.log(reduce_from(se, tp))
        local = labels.long() - tp.index * cols
        mine = (local >= 0) & (local < cols)
        ll = torch.gather(logits_f32, -1,
                          local.clamp(0, cols - 1)[..., None])[..., 0]
        ll = reduce_from(torch.where(mine, ll, torch.zeros(
            (), dtype=ll.dtype, device=ll.device)), tp)
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


@dataclasses.dataclass
class DistCtx:
    """How a model call meets the mesh (None: one device). The port runs
    one process a rank, so the tensors a call sees are already this rank's
    shards; the ctx says which mesh, which of its axes are the data axes
    and the model axis, and how the decode cache is laid out.
    kv_seq_shard: the decode cache's seq dim is split over `model_axis`
    (attention.flash_decode_sharded: partial softmax stats all-reduced).
    ep_data: a moe layer's experts are split over the data axes and large
    token counts take the expert-parallel route (moe.moe_ffn_ep). Over
    data axes of more than one rank a batch holds this rank's rows, and
    the training loss and the moe capacity route compute the global
    batch's function (registry.loss_fn, registry._moe_apply). Over a
    model axis of more than one rank under the training plan, the weights
    whose contraction dim is split (`row_parallel`) sum their partials
    over `model_group()`."""
    mesh: Any = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    kv_seq_shard: bool = False
    ep_data: bool = False

    def data_group(self):
        """The collectives over the data axes (dist.collectives.AxesGroup;
        one rank without a mesh)."""
        group = self.__dict__.get("_data_group")
        if group is None:
            from repro_torch.dist.collectives import AxesGroup
            group = AxesGroup(self.mesh, self.data_axes)
            self.__dict__["_data_group"] = group
        return group

    @property
    def data_size(self) -> int:
        """How many ranks split the batch (1 on one device)."""
        return self.data_group().size

    @property
    def data_rank(self) -> int:
        """This rank's index over the data axes (0 on one device): its
        rows are block `data_rank` of the global batch."""
        return self.data_group().index

    @property
    def model_size(self) -> int:
        """The model axis's size (1 on one device or a mesh without it)."""
        if self.mesh is None:
            return 1
        return int(self.mesh.shape.get(self.model_axis, 1))

    @property
    def model_rank(self) -> int:
        """This rank's index on the model axis (0 on one device)."""
        if self.mesh is None:
            return 0
        return int(self.mesh.coords.get(self.model_axis, 0))

    def model_group(self):
        """The collectives over the model axis (dist.collectives.AxesGroup;
        one rank without a mesh or on an axis of 1)."""
        group = self.__dict__.get("_model_group")
        if group is None:
            from repro_torch.dist.collectives import AxesGroup
            group = AxesGroup(self.mesh, (self.model_axis,))
            self.__dict__["_model_group"] = group
        return group

    def row_parallel(self, local: int, whole: int):
        """The model group where a contraction dim of `whole` (a wo's rows,
        the vocab of an embedding) is split over the model axis, this
        rank holding `local` of it: the reference training plan's
        row-parallel weights, whose products sum partials over the group.
        None where the dim is whole (one device, the serve plan, a dim the
        axis does not divide)."""
        if local == whole or self.model_size == 1:
            return None
        group = self.model_group()
        if local * group.size != whole:
            raise ValueError(f"{local} of {whole} a rank over a model axis "
                             f"of {group.size}")
        return group

    def tp_shards(self, *dims: int) -> int:
        """How many ways the model axis splits dims that are all divisible
        by it (1 when any is not: the spec_for replication fallback)."""
        tp = self.model_size
        if tp > 1 and all(d % tp == 0 for d in dims):
            return tp
        return 1
