"""Logical-axis -> mesh-axis assignment (the sharding engine) — the port
of `repro.dist.sharding` (:42-288), plus `local_shard`, which cuts a
rank's block out of a whole tensor (the port runs one process a rank, so
there is no GSPMD to place the blocks).

Every param/cache/batch leaf carries *logical axes* (recorded by
ParamInit / `Model.cache_axes()`, e.g. ("layers", "d_model", "d_ff")).
`spec_for` maps those names onto mesh axes under a ShardingPlan, with the
reference's two invariants:

  * divisibility: a mesh axis (or axis group) is only assigned to a dim
    whose size it divides; a non-divisible candidate REPLICATES instead
    (e.g. qwen2-1.5b's 2 kv heads on a 4-way model axis);
  * no reuse: a mesh axis appears at most once per spec.

Assignment order (first claim wins):
  1. TP: the `model` axis goes to the highest-priority tensor dim — with
     `kv_seq_shard`, the KV-cache seq dim steals it (distributed
     flash-decode) ahead of the usual last-to-first scan over
     d_ff / heads / kv_heads / vocab dims;
  2. EP: with `ep_data`, MoE expert dims take the dp axes;
  3. DP: batch dims (activations only) take the longest prefix of the dp
     axes whose product divides the batch;
  4. FSDP: params additionally scatter the dp axes onto the LARGEST dim
     that still divides.

A spec is a tuple with one entry a dim: None, a mesh-axis name, or a
tuple of names (major first) — `tuple(jax.sharding.PartitionSpec)`. The
plan reads only `mesh.shape` as a name -> size mapping, so any object
with that attribute plans (launch.mesh.Mesh, or a stand-in).

A leaf whose last dim packs several tensors side by side (ParamInit's
parts=, `Model.param_parts`: mamba's in_proj, xs | z) takes a
`PackedSpec` in the serve and training plans' trees
(`params_shardings(parts=)`): a rank's block of it is its block of each
part (`local_shard`), `column_blocks` records its parts, and
`gather_tree` puts the parts back whole, so the optimizer state and the
checkpoint follow the param's layout.

Under FSDP beside a model axis, `spec_for` may split one dim over the
model axis and the data axes together, model first (`('model', 'data')`,
`('model', 'pod', 'data')`): the dim's blocks are model-major, so a
rank's block is its model rank's block cut again, contiguously, over the
data axes, and a gather over the data group gives back the model rank's
block (what the tensor-parallel forward reads), a gather over the model
group after it the whole leaf (`local_shard`, `gather_tree`). A packed
leaf keeps its packing there: the model rank's block is its block of
each part, and the data axes cut that block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

LogicalAxes = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]
PyTree = Any

# Tensor dims eligible for the model (TP) axis. The scan runs over dims
# last-to-first, so the output-feature dim of a projection wins over its
# input dim.
_TP_NAMES = ("d_ff", "heads", "kv_heads", "vocab")


@dataclasses.dataclass
class ShardingPlan:
    """How one (model x mesh x cell-kind) combination maps onto the mesh.

    dp_axes: data-parallel mesh axes in outer-to-inner order.
    fsdp: scatter params/optimizer over the dp axes.
    kv_seq_shard: decode-time KV seq dim takes the model axis
        (distributed flash-decode).
    ep_data: MoE expert dims shard over the dp axes (EP).
    tp_out_dims_only: params take the model axis ONLY on their last
        (output-feature) dim — column-parallel everywhere, no row-parallel
        weights. Every cross-rank combine is then a concatenation
        (all-gather), never a sum, so sharded execution is bit-exact by
        construction (the serving plan's contract; serve_specs and
        layers.exact_tp_scope).
    """
    mesh: Any
    dp_axes: Tuple[str, ...] = ()
    fsdp: bool = False
    kv_seq_shard: bool = False
    ep_data: bool = False
    tp_out_dims_only: bool = False

    @property
    def tp_axis(self) -> Optional[str]:
        return "model" if "model" in self.mesh.shape else None

    def axis_size(self, name: str) -> int:
        return int(self.mesh.shape[name])

    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.axis_size(a)
        return n


class PackedSpec(tuple):
    """A spec (equal to the plain tuple) whose leaf packs `parts` equal
    tensors side by side along its last dim, which the model axis splits
    (alone, or first beside data axes): a model rank's block is its block
    of each part, concatenated, and data axes after it cut that block
    contiguously (`local_shard`)."""

    def __new__(cls, spec, parts: int):
        self = super().__new__(cls, spec)
        self.parts = parts
        return self

    def __getnewargs__(self):
        return tuple(self), self.parts


def spec_parts(spec) -> int:
    """The parts a spec's leaf packs along its last dim (1 for a plain
    spec)."""
    return getattr(spec, "parts", 1)


def packed_parts(specs: PyTree) -> PyTree:
    """The tree of `specs` with each leaf's `spec_parts`."""
    if isinstance(specs, dict):
        return {k: packed_parts(v) for k, v in specs.items()}
    return spec_parts(specs)


def spec_for(plan: ShardingPlan, axes: Sequence[Optional[str]],
             shape: Sequence[int], *, is_param: bool = True) -> Spec:
    """The spec of one leaf with logical `axes` and concrete `shape`.

    is_param=True leaves are weights (TP + EP + FSDP apply); False leaves
    are activations / caches (TP + DP apply). Every rule falls back to
    replication when divisibility fails."""
    axes = tuple(axes)
    assert len(axes) == len(shape), (axes, shape)
    n = len(axes)
    assigned: list = [[] for _ in range(n)]
    used: set = set()

    def divisor(i: int) -> int:
        d = 1
        for a in assigned[i]:
            d *= plan.axis_size(a)
        return d

    def fits(i: int, names: Tuple[str, ...]) -> bool:
        if any(a in used for a in names):
            return False
        d = divisor(i)
        for a in names:
            d *= plan.axis_size(a)
        return shape[i] % d == 0

    def take(i: int, names: Tuple[str, ...]) -> None:
        assigned[i].extend(names)
        used.update(names)

    def longest_dp_prefix(i: int) -> Tuple[str, ...]:
        for k in range(len(plan.dp_axes), 0, -1):
            names = tuple(plan.dp_axes[:k])
            if fits(i, names):
                return names
        return ()

    # 1. TP: the model axis goes to exactly one tensor dim
    tp = plan.tp_axis
    if tp is not None:
        candidates = []
        if not is_param and plan.kv_seq_shard:
            candidates += [i for i in reversed(range(n))
                           if axes[i] == "kv_seq"]
        if is_param and plan.tp_out_dims_only:
            # column-parallel only: a weight may shard its LAST dim (the
            # output features); contraction dims replicate (exact-TP)
            if n and axes[n - 1] in _TP_NAMES:
                candidates.append(n - 1)
        else:
            candidates += [i for i in reversed(range(n))
                           if axes[i] in _TP_NAMES]
        for i in candidates:
            if fits(i, (tp,)):
                take(i, (tp,))
                break

    # 2. EP: expert dims over the dp axes (params only)
    if is_param and plan.ep_data:
        for i in range(n):
            if axes[i] == "experts":
                names = longest_dp_prefix(i)
                if names:
                    take(i, names)
                break

    # 3. DP: batch dims over the dp axes (activations only)
    if not is_param:
        for i in range(n):
            if axes[i] == "batch":
                names = longest_dp_prefix(i)
                if names:
                    take(i, names)
                break

    # 4. FSDP: params scatter the still-unused dp axes onto the largest
    # dividing dim (EP may have claimed a prefix)
    if is_param and plan.fsdp and plan.dp_axes:
        avail = tuple(a for a in plan.dp_axes if a not in used)
        for k in range(len(avail), 0, -1):
            names = tuple(avail[:k])
            eligible = [i for i in range(n) if fits(i, names)]
            if eligible:
                take(max(eligible, key=lambda i: shape[i]), names)
                break

    entries = []
    for names in assigned:
        if not names:
            entries.append(None)
        elif len(names) == 1:
            entries.append(names[0])
        else:
            entries.append(tuple(names))
    return tuple(entries)


# ---------------------------------------------------------------------------
# tree builders
# ---------------------------------------------------------------------------

def params_shardings(plan: ShardingPlan,
                     param_axes: Dict[str, LogicalAxes],
                     ab_params: PyTree,
                     parts: Optional[Dict[str, int]] = None) -> PyTree:
    """The spec tree of a params tree (leaves: anything with a `.shape`);
    `param_axes` maps "a/b/c" nesting paths to logical axes
    (ParamInit.axes, `Model.param_axes`). Leaves without a recorded path
    replicate. parts: the packed leaves (`Model.param_parts`); one whose
    last dim the model axis splits (alone, or first beside data axes)
    takes a PackedSpec."""
    parts = parts or {}

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        axes = param_axes.get(path) or (None,) * len(node.shape)
        spec = spec_for(plan, axes, tuple(node.shape), is_param=True)
        if (parts.get(path, 1) > 1 and plan.tp_axis is not None
                and _names(spec[-1])[:1] == (plan.tp_axis,)):
            return PackedSpec(spec, parts[path])
        return spec

    return walk(ab_params)


def cache_shardings(plan: ShardingPlan, cache_axes: PyTree,
                    abstract_cache: PyTree) -> PyTree:
    """The spec tree of a decode cache; `cache_axes` mirrors the cache
    with logical-axes tuples (`Model.cache_axes()`)."""

    def walk(ax_node, ab_node):
        if isinstance(ab_node, dict):
            return {k: walk(ax_node[k], v) for k, v in ab_node.items()}
        axes = tuple(ax_node) if ax_node else (None,) * len(ab_node.shape)
        return spec_for(plan, axes, tuple(ab_node.shape), is_param=False)

    return walk(cache_axes, abstract_cache)


@dataclasses.dataclass
class ServeShardings:
    """How a ServeEngine lays its state out on a serving mesh.

    params / cache are spec trees matching the model's param tree and the
    slot scheduler's batched decode cache (whose "pos" is a (B,) per-slot
    vector). replicated is the () spec of everything the host-side
    scheduler owns (tokens, active masks, logits): scheduler state is the
    same on every rank, so the FIFO slot loop does not depend on the
    rank count."""
    plan: ShardingPlan
    params: PyTree
    cache: PyTree
    replicated: Spec


def serve_specs(cfg, mesh, *, max_batch: int, cache_len: int,
                model=None) -> ServeShardings:
    """Sharding layout for tensor-parallel serving of `cfg` over `mesh`.

    The plan is TP-only (no dp axes) and exact-TP (tp_out_dims_only): the
    `model` mesh axis shards weights column-parallel on their output dims
    (heads / d_ff / vocab) and the per-slot K/V cache head-wise via its
    "kv_heads" logical axis; contraction dims never shard, and the
    row-parallel matmuls all-gather their activation under
    `layers.exact_tp_scope` instead of summing partials. Every cross-rank
    combine is a concatenation of values computed whole on one rank, so
    sharded serving is bit-exact against the single-device engine, at the
    cost of computing the down-projections redundantly on every rank.
    Dims the mesh does not divide (2 kv heads on a 4-way axis) replicate.

    model: optionally the already-built Model for cfg (ServeEngine passes
    its own)."""
    if model is None:
        from repro_torch.models.registry import build_model
        model = build_model(cfg)
    plan = ShardingPlan(mesh=mesh, dp_axes=(), tp_out_dims_only=True)
    params = params_shardings(plan, model.param_axes,
                              model.abstract_params(), model.param_parts)
    cache = cache_shardings(plan, model.cache_axes(),
                            model.init_cache(max_batch, cache_len,
                                             abstract=True))
    # the slot scheduler's per-row write position: host-owned, replicated
    cache["pos"] = ()
    return ServeShardings(plan=plan, params=params, cache=cache,
                          replicated=())


def batch_shardings(plan: ShardingPlan, batch: PyTree) -> PyTree:
    """The spec tree of an input batch: dim 0 is the global batch (split
    over the dp axes when divisible), the rest replicate."""

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if not tuple(x.shape):                 # scalar leaf: replicated
            return ()
        axes = ("batch",) + (None,) * (len(x.shape) - 1)
        return spec_for(plan, axes, tuple(x.shape), is_param=False)

    return leaf(batch)


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------

def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _block(entry, mesh, coords) -> Tuple[int, int]:
    """(this rank's block index, block count) along a dim with `entry`:
    the named axes' coordinates as one mixed-radix number, the first name
    the most significant."""
    idx, count = 0, 1
    for a in _names(entry):
        idx = idx * int(mesh.shape[a]) + int(coords[a])
        count *= int(mesh.shape[a])
    return idx, count


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of `shape` under `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, entry in zip(shape, spec):
        count = 1
        for a in _names(entry):
            count *= int(mesh.shape[a])
        out.append(n // count)
    return tuple(out)


def local_shard(t: torch.Tensor, spec: Spec, mesh,
                coords: Optional[Dict[str, int]] = None, *,
                parts: Optional[int] = None) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec`: a view (the
    caller copies it to free the whole). Mesh axes are laid out
    rank-major in the order of `mesh.shape`; `coords` (default
    `mesh.coords`) picks another rank's block.

    parts > 1 (default: the spec's own, `spec_parts`): the last dim packs
    `parts` equal tensors side by side (ParamInit's parts=; mamba's
    in_proj is xs | z), and where it is split the rank takes its block of
    each over the dim's first axis (the model axis), concatenated in order
    (a copy), so a local chunk into `parts` gives the rank's block of
    every part: the same bytes as the rank-major block, another layout.
    The dim's further axes (the data axes of a co-split dim) then cut
    that block contiguously: a gather over them gives it back whole."""
    coords = mesh.coords if coords is None else coords
    parts = spec_parts(spec) if parts is None else parts
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, count = _block(entry, mesh, coords)
        n = parts if d == t.dim() - 1 else 1
        if t.shape[d] % (count * n):
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"{count} ways ({entry}) in each of {n} "
                             f"parts")
        if n == 1:
            width = t.shape[d] // count
            t = t.narrow(d, idx * width, width)
            continue
        names = _names(entry)
        idx, count = _block(names[:1], mesh, coords)
        piece = t.shape[d] // n
        width = piece // count
        t = torch.cat([t.narrow(d, p * piece + idx * width, width)
                       for p in range(n)], dim=d)
        idx, count = _block(names[1:], mesh, coords)
        width = t.shape[d] // count
        t = t.narrow(d, idx * width, width)
    return t


def unpack_parts(t: torch.Tensor, ranks: int, parts: int) -> torch.Tensor:
    """The whole tensor from `ranks` blocks gathered in rank order along
    the last dim, each rank's block holding its block of each of `parts`
    packed tensors (`local_shard`'s layout): every part's blocks put back
    together, part after part."""
    if parts == 1:
        return t
    shape = t.shape[:-1]
    n = t.shape[-1] // (ranks * parts)
    return t.reshape(*shape, ranks, parts, n).transpose(-3, -2).reshape(
        *shape, ranks * parts * n)



def column_blocks(local: PyTree, specs: PyTree, mesh
                  ) -> Dict[int, Tuple[int, int, int]]:
    """This rank's column-split weights in `local` (its shards under
    `specs`, each leaf a tensor of its own): for every leaf whose last dim
    is split, its storage's address -> (the whole last dim, the packed
    parts (`spec_parts`), this rank's block). The engine hands it to
    layers.exact_tp_scope(columns=), so a product of such a weight, or of
    a layer's slice of it, keeps the same columns of the whole product's
    bits (layers._column_product) with no call site restating the
    layout."""
    out = {}
    for k, v in local.items():
        if isinstance(v, dict):
            out.update(column_blocks(v, specs[k], mesh))
            continue
        spec = tuple(specs[k]) + (None,) * (v.dim() - len(specs[k]))
        if v.dim() and spec[-1] is not None:
            idx, count = _block(spec[-1], mesh, mesh.coords)
            if count > 1:
                out[v.untyped_storage().data_ptr()] = (
                    v.shape[-1] * count, spec_parts(specs[k]), idx)
    return out


# ---------------------------------------------------------------------------
# the training trees
# ---------------------------------------------------------------------------

def opt_state_specs(param_specs: PyTree, opt_state: PyTree) -> PyTree:
    """The spec tree of an optimizer state (the port of the reference's
    `_opt_state_shardings`, train/step.py:67-96). AdamW's m and v take
    their param's spec. Adafactor's factored stats are split only where
    their param is: vr (the mean over the last dim) keeps the param's
    spec without its last entry, vc (the mean over the second-last) the
    spec without that one (a packed param's vc keeps its PackedSpec); a
    vector's v takes its param's. A dim split over the model axis and the
    data axes together keeps that entry in every stat that has the dim.
    (The reference recomputes spec_for on the stats' own shapes, which can
    pick another dim; the values are the same, and checkpoints hold whole
    leaves.) step replicates."""
    if "m" in opt_state:
        return {"m": param_specs, "v": param_specs, "step": ()}

    def build(spec_node, state_node):
        if "vr" in state_node or "v" in state_node:
            if "v" in state_node:
                return {"v": spec_node}
            spec = tuple(spec_node)
            vc = spec[:-2] + spec[-1:]
            if spec_parts(spec_node) > 1:         # vc keeps the packed dim
                vc = PackedSpec(vc, spec_parts(spec_node))
            return {"vr": spec[:-1], "vc": vc}
        return {k: build(spec_node[k], v) for k, v in state_node.items()}

    return {"f": build(param_specs, opt_state["f"]), "step": ()}


def data_dims(plan: ShardingPlan, specs: PyTree) -> PyTree:
    """The tree of `specs` with, for each leaf, the dim the plan's data
    axes split (None where the leaf is whole on every data rank): FSDP's
    or EP's dim, whether the model axis splits it too (a co-split dim,
    `('model', 'data')`: the data axes cut the model rank's block) or
    not. A leaf split over only some of the data axes of more than one
    rank, or on two dims, is refused."""
    mesh = plan.mesh
    big = tuple(a for a in plan.dp_axes if int(mesh.shape[a]) > 1)

    def leaf(spec):
        if isinstance(spec, dict):
            return {k: leaf(v) for k, v in spec.items()}
        dims = [(i, tuple(a for a in _names(e) if a in big))
                for i, e in enumerate(spec)]
        dims = [(i, names) for i, names in dims if names]
        if not dims:
            return None
        if len(dims) > 1 or dims[0][1] != big:
            raise NotImplementedError(
                f"spec {spec}: a leaf split over the data axes {big} on "
                f"one dim, all of them in order")
        return dims[0][0]

    return leaf(specs)


def model_dims(plan: ShardingPlan, specs: PyTree) -> PyTree:
    """The tree of `specs` with, for each leaf, the dim the plan's model
    axis splits (None where spec_for left the leaf whole on every model
    rank: no TP name, or a dim the axis does not divide); data_dims'
    counterpart. The dim may be split over the model axis alone, or over
    the model axis first and then data axes (FSDP beside TP, the order
    spec_for makes); any other mix (data axes before the model axis,
    another axis beside it, the model axis on two dims) is refused."""
    tp = plan.tp_axis
    big = tp is not None and plan.axis_size(tp) > 1

    def leaf(spec):
        if isinstance(spec, dict):
            return {k: leaf(v) for k, v in spec.items()}
        if not big:
            return None
        dims = [i for i, e in enumerate(spec) if tp in _names(e)]
        if len(dims) > 1:
            raise NotImplementedError(
                f"spec {spec}: the model axis on dims {dims}; one dim, the "
                f"model axis first, then only data axes {plan.dp_axes}")
        if not dims:
            return None
        names = _names(spec[dims[0]])
        if names[0] != tp or not set(names[1:]) <= set(plan.dp_axes):
            raise NotImplementedError(
                f"spec {spec}: dim {dims[0]} split over {names}; the model "
                f"axis first, then only data axes {plan.dp_axes}")
        return dims[0]

    return leaf(specs)


def local_batch(plan: ShardingPlan, batch: PyTree) -> PyTree:
    """This rank's rows of a global batch (dim 0 split over the data axes,
    rank-major: `batch_shardings`, then `local_shard`). The rows must
    split evenly: spec_for would replicate them, and every rank would
    then count the whole batch."""
    n = plan.dp_size()

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if x.dim() and x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {n} data ranks")
        return local_shard(x, batch_shardings(plan, x), plan.mesh)

    return leaf(batch)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Each leaf's local block under its spec (a contiguous copy; a
    PackedSpec's leaf in its packed layout). A leaf without a spec stays
    whole."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs.get(k, ()) if isinstance(specs, dict)
                              else (), mesh)
                for k, v in tree.items()}
    return local_shard(tree, specs, mesh).contiguous().clone()


def gather_tree(tree: PyTree, dims: PyTree, group, device=None, *,
                model_dims: PyTree = None, model_group=None,
                parts: PyTree = None) -> PyTree:
    """The whole leaves of a tree of local blocks: each leaf all-gathered
    over `group` (dist.collectives.AxesGroup) along its dim of `dims`
    (data_dims), in rank order, and then over `model_group` along its dim
    of `model_dims` (model_dims) where given, a packed leaf's parts put
    back whole (`parts`: packed_parts of the specs; `unpack_parts`); a
    leaf whose dims are None is copied. The data gather comes first: on a
    dim split over both (model-major blocks) it gives back the model
    rank's block, which the model gather then joins. Leaves go to
    `device` when given (the host, for a checkpoint), one at a time, in
    sorted-key order on every rank."""

    def sub(d, k):
        return d.get(k) if isinstance(d, dict) else None

    if isinstance(tree, dict):
        return {k: gather_tree(tree[k], sub(dims, k), group, device,
                               model_dims=sub(model_dims, k),
                               model_group=model_group, parts=sub(parts, k))
                for k in sorted(tree)}
    t = tree.detach()
    if dims is None and model_dims is None:
        t = t.clone()
    if dims is not None:
        t = group.all_gather(t, dims)
    if model_dims is not None:
        t = unpack_parts(model_group.all_gather(t, model_dims),
                         model_group.size, parts or 1)
    return t if device is None else t.to(device)
