"""Static per-kernel census: count what the PLAIN VERSION of a registered
`(kernel, version, problem shape)` would compute, without computing it —
the port of `repro.analyze.census`.

The JAX package walks a traced jaxpr. Here the version's plain version
(the torch code a CPU tensor takes) runs under `FakeTensorMode`, so every
tensor has a shape and a dtype and no data, and a `TorchDispatchMode`
counts each aten op it dispatches:

  * `flops` / `dot_flops` / `tc_flops` — mul, add/sub, elementwise ops
    and comparisons on float operands count 1 FLOP an output element, a
    reduction 1 an input element (`_softmax` 5: max, sub, exp, sum, div);
    `mm`/`bmm`/`addmm`/`baddbmm` count 2·M·N·K, and `tc_flops` is the
    part of those on bf16/f16 operands (the tensor cores' rate); data
    movement (views, copies, casts, indexing) is free;
  * `fma_fraction` — `2·min(mul, add/sub) / flops`, the paper's FMA lens;
  * `hbm_bytes` — compulsory bytes: the inputs plus the outputs;
  * `op_bytes` / `launches` — every aten op dispatched that is not a view
    (nor a `prim` metadata query) is a kernel eager PyTorch launches, and
    each reads its inputs from HBM and writes its outputs there:
    `launches` counts those ops, `op_bytes` sums their inputs' and
    outputs' bytes (an in-place op's tensor once read, once written).
    Where the plain version is the program (gpp v0–v5), `op_bytes` is
    the traffic it moves, `hbm_bytes` the least any program could;
  * `bound_s` — `max(flops / customized_ceiling, hbm_bytes / hbm_bw)` on
    the spec given (core.roofline), which MODEL001 holds `model_step_s`
    against;
  * duplicates — ops of at least DUP_MIN_FLOPS keyed by (op, operand
    identities, shape): a second one recomputes a value (DUP001).

The launch columns come from the descriptor's hooks, for versions that
launch a kernel: `smem_config_bytes` (`config_smem_bytes`), `grid_blocks`
(`launch_grid`) and, on the card only, `smem_launch_bytes` (the library's
own count, `library_launch_shape`). They are None for plain-only versions.

`census_step` counts a whole train, prefill or decode step the same
way, as one rank of a mesh no process runs (`launch.mesh.abstract_mesh`):
its arguments cut to the rank's blocks and made fake, its collectives
counted by the step's `AxesGroup`s, and the bytes alive at once tracked
op by op (`StepCensus`; launch/dryrun.py prices it on the roofline).

For gpp v6–v10 the census counts the plain version's arithmetic (the
kernels' block decomposition in torch), not the compiled band loop: the
kernel's own instruction mix is the SASS census (`core.sass`,
`chip_smoke.py`'s phase 2b). The plain scan contracts h·c over N with
`bmm`, so its `dot_flops` are not 0 where the JAX Pallas scan's are; both
have 0 `tc_flops`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch import backend
from repro_torch.core import hw
from repro_torch.core.roofline import customized_ceiling

# aten op classes (overload packet names, an in-place op's trailing "_"
# dropped). Every class counts only when an operand or result is float.
_MUL_OPS = {"mul"}
_ADDSUB_OPS = {"add", "sub", "rsub"}
_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm"}
_EW_OPS = {
    "div", "reciprocal", "rsqrt", "sqrt", "exp", "exp2", "expm1", "log",
    "log1p", "log2", "tanh", "sigmoid", "softplus", "silu", "gelu", "relu",
    "pow", "erf", "erfc", "erfinv", "sin", "cos", "tan", "atan2",
    "remainder", "fmod", "neg", "abs", "sign", "sgn", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "floor", "ceil", "round", "trunc",
    "where", "square", "ge", "gt", "le", "lt", "eq", "ne", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "isfinite", "isnan", "complex",
    "nextafter", "lerp", "addcmul", "addcdiv",
}
_SUM_OPS = {"sum", "cumsum", "mean"}
_REDUCE_OPS = {"amax", "amin", "prod", "argmax", "argmin", "cumprod",
               "cummax", "cummin", "logsumexp", "all", "any", "max", "min",
               "norm", "var", "std"}
_SOFTMAX_OPS = {"_softmax", "_log_softmax"}
_TC_DTYPES = (torch.bfloat16, torch.float16)
# ops cheaper than this many FLOPs are not fingerprinted for duplicates
DUP_MIN_FLOPS = 1024.0


def _float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(items) -> List[torch.Tensor]:
    """The tensors among `items`, and inside lists, tuples and dicts of
    them."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
        elif isinstance(x, dict):
            out.extend(_tensors(x.values()))
    return out


_CLASSES: Dict[Any, str] = {}


def _op_class(func) -> str:
    """The census class of an aten overload (memoized)."""
    klass = _CLASSES.get(func)
    if klass is None:
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.startswith("_"):
            name = name[:-1]          # in-place form
        if name in _DOT_OPS:
            klass = "dot"
        elif name in _MUL_OPS:
            klass = "mul"
        elif name in _ADDSUB_OPS:
            klass = "addsub"
        elif name in ("max", "min") and func._overloadname == "other":
            klass = "ew"              # the binary elementwise form
        elif name in _EW_OPS:
            klass = "ew"
        elif name in _SUM_OPS:
            klass = "sum"
        elif name in _REDUCE_OPS:
            klass = "reduce"
        elif name in _SOFTMAX_OPS:
            klass = "softmax"
        else:
            klass = "free"
        _CLASSES[func] = klass
    return klass


class _Counter(TorchDispatchMode):
    """Counts every aten op dispatched while it is on (under a
    FakeTensorMode: shapes and dtypes only)."""

    # fingerprint ops for DUP001 (keeps their operands alive)
    duplicates = True

    def __init__(self):
        super().__init__()
        self.flops = self.dot_flops = self.tc_flops = 0.0
        self.mul_flops = self.addsub_flops = 0.0
        self.float_dtypes = set()
        self.launches = 0
        self.op_bytes = 0.0
        self.duplicate_eqns = 0
        self.duplicate_flops = 0.0
        self._seen = set()
        self._alive = []       # operands of fingerprinted ops: ids stay unique

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors((out,))
        if not func.is_view and func.namespace == "aten":
            self.launches += 1
            self.op_bytes += float(sum(_nbytes(t) for t in ins + outs))
        floats = [t for t in ins + outs if _float(t.dtype)]
        for t in floats:
            self.float_dtypes.add(str(t.dtype).replace("torch.", ""))
        klass = _op_class(func)
        if klass == "free" or not floats:
            return out
        if klass == "dot":
            a, b = ins[-2], ins[-1]              # (.., M, K) x (.., K, N)
            f = 2.0 * outs[0].numel() * a.shape[-1]
            self.dot_flops += f
            if a.dtype in _TC_DTYPES and b.dtype in _TC_DTYPES:
                self.tc_flops += f
        elif klass in ("sum", "reduce", "softmax"):
            f = float(ins[0].numel()) * (5.0 if klass == "softmax" else 1.0)
        else:
            f = float(outs[0].numel())
        if f <= 0.0:
            return out
        self.flops += f
        if klass == "mul":
            self.mul_flops += f
        elif klass in ("addsub", "sum"):
            self.addsub_flops += f
        elif klass == "softmax":
            self.addsub_flops += 0.4 * f     # its sub and its sum
        if self.duplicates and f >= DUP_MIN_FLOPS:
            ops = tuple(("t", id(a)) if isinstance(a, torch.Tensor)
                        else ("l", repr(a)) for a in args)
            fp = (func, ops, tuple(outs[0].shape) if outs else ())
            if fp in self._seen:
                self.duplicate_eqns += 1
                self.duplicate_flops += f
            else:
                self._seen.add(fp)
                self._alive.append(args)
        return out

    @property
    def fma_flops(self) -> float:
        """FLOPs retiring in mul+add pairs: 2 per pairable (mul, add)."""
        return 2.0 * min(self.mul_flops, self.addsub_flops)


@dataclasses.dataclass
class KernelCensus:
    """The auditor's record of one (kernel, version, shape): the plain
    version's counts and the launch's shape (schema: the module
    docstring; `unbounded_loops` is kept from the JAX schema and is 0:
    eager torch traces no loop)."""
    kernel: str
    version: str
    key_name: str
    key_dims: str
    flops: float
    dot_flops: float
    tc_flops: float                     # dot FLOPs on bf16/f16 operands
    fma_flops: float
    fma_fraction: float
    hbm_bytes: float                    # compulsory: inputs + outputs
    op_bytes: float                     # every launched op's ins + outs
    launches: int                       # aten ops dispatched, not views
    smem_launch_bytes: Optional[int]    # the library's count (card only)
    smem_config_bytes: Optional[int]    # the descriptor's model
    arithmetic_intensity: float         # flops / hbm_bytes
    grid_blocks: Optional[int]          # blocks of the launch
    unbounded_loops: int
    duplicate_eqns: int
    duplicate_flops: float
    float_dtypes: Tuple[str, ...]
    bound_s: float                      # census roofline lower bound
    model_s: Optional[float]            # the descriptor's model_step_s
    config: Optional[Dict] = None

    def row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["float_dtypes"] = list(self.float_dtypes)
        return d


def resolve_config(k, version: str, key, spec: Optional[hw.GpuSpec] = None
                   ) -> Optional[Any]:
    """The config the auditor charges `version` with: the clamped static
    config when the version has one, else the model-ranked top candidate
    (on `spec`) for tunable versions. Deterministic: never reads the tune
    cache, never times anything (unlike `api.resolve_config`)."""
    cfg = k.static_config(key, version)
    if cfg is None and version in k.tunable:
        from repro_torch.tune import tuner
        ranked = tuner.rank_kernel(k.name, key, version=version,
                                   device=spec or hw.DEFAULT_SPEC)
        if ranked:
            cfg = k.finalize_config(ranked[0][0], version)
    return cfg


def _fake(mode: FakeTensorMode, tree):
    return tree_map(lambda x: mode.from_tensor(x)
                    if isinstance(x, torch.Tensor) else x, tree)


def census_kernel(kernel, version: str, key, *, config: Any = None,
                  spec: Optional[hw.GpuSpec] = None,
                  device=backend.DEFAULT_DEVICE) -> KernelCensus:
    """Count the plain version of `(kernel, version, key)` on fake
    tensors from the kernel's `make_example`: nothing is computed.
    `config=None` resolves via `resolve_config`; `spec` (default: the
    spec of `device`) prices the bound and the model. On the card (the
    default device; raises without one) the library's own shared memory
    of the launch fills `smem_launch_bytes`; device='cpu' prices on
    hw.DEFAULT_SPEC unless given a spec.

    Example::

        from repro_torch.analyze.census import census_kernel
        from repro_torch.kernels.gpp import problem
        c = census_kernel("gpp", "v10", problem.TINY, device="cpu")
        c.flops > 0 and 0 <= c.fma_fraction <= 1    # True
    """
    from repro_torch.kernels import api
    k = api.get_kernel(kernel) if isinstance(kernel, str) else kernel
    device = backend.resolve_device(device)
    spec = spec or hw.spec_for_device(device)
    cfg = config if config is not None else resolve_config(k, version, key,
                                                           spec)
    args, kwargs = k.make_example(key)
    with FakeTensorMode() as mode:
        args, kwargs = _fake(mode, args), _fake(mode, kwargs)
        counter = _Counter()
        with counter:
            out = k.run(*args, version=version, config=cfg, device="cpu",
                        **kwargs)
    hbm = float(sum(_nbytes(t) for t in
                    _tensors((args, tuple(kwargs.values()), out))))

    smem_cfg = smem_lib = grid = model_s = None
    if cfg is not None:
        clamped = k.clamp(cfg, key)
        smem_cfg = k.config_smem_bytes(clamped, key, version=version,
                                       spec=spec)
        if not k.config_divides(clamped, key):
            grid = k.launch_grid(clamped, key, version=version, spec=spec)
        if device.type == "cuda":
            shape = k.library_launch_shape(clamped, key, version)
            smem_lib = None if shape is None else shape[0]
        try:
            model_s = float(k.model_step_s(key, cfg, version, spec))
        except NotImplementedError:
            model_s = None

    peak = customized_ceiling(counter.flops, counter.tc_flops, spec)
    bound_s = max(counter.flops / peak, hbm / spec.hbm_bw)
    return KernelCensus(
        kernel=k.name,
        version=version,
        key_name=getattr(key, "name", "?"),
        key_dims=key.key_dims(),
        flops=counter.flops,
        dot_flops=counter.dot_flops,
        tc_flops=counter.tc_flops,
        fma_flops=counter.fma_flops,
        fma_fraction=(counter.fma_flops / counter.flops
                      if counter.flops > 0 else 0.0),
        hbm_bytes=hbm,
        op_bytes=counter.op_bytes,
        launches=counter.launches,
        smem_launch_bytes=smem_lib,
        smem_config_bytes=smem_cfg,
        arithmetic_intensity=counter.flops / hbm if hbm > 0 else 0.0,
        grid_blocks=grid,
        unbounded_loops=0,
        duplicate_eqns=counter.duplicate_eqns,
        duplicate_flops=counter.duplicate_flops,
        float_dtypes=tuple(sorted(counter.float_dtypes)),
        bound_s=bound_s,
        model_s=model_s,
        config=k.config_to_json(cfg) if cfg is not None else None,
    )


# ---------------------------------------------------------------------------
# a whole step on one rank of an abstract mesh
# ---------------------------------------------------------------------------

class _LiveCounter(_Counter):
    """_Counter that also tracks the bytes alive at once: every storage
    from the op that makes it until the last tensor on it is freed (a
    `weakref.finalize` on the storage, whose Python object PyTorch keeps
    as long as the storage lives; autograd's saved tensors included). A
    view or an in-place op makes no storage, so an argument updated in
    place (a donated one) counts once. `peak` is the high-water mark. No
    duplicate fingerprints: they would keep every operand alive."""

    duplicates = False

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._storages = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in _tensors((out,)):
            self.track(t)
        return out


@dataclasses.dataclass
class StepCensus:
    """One rank's census of a step (`census_step`): the op counts of
    `_Counter` (`flops`, `tc_flops`, `op_bytes`, `launches`: every aten
    op the step dispatches on the CPU, so the plain versions in the
    kernels' places), the collectives by group ("data", "model") as
    {"calls": {kind: n}, "bytes": {kind: bytes}} from the step's
    AxesGroups, the bytes of each argument tree a rank holds (`params`,
    `opt_state`, `cache`, `batch`; `grads`: the reduced grads the
    optimizer takes, the params' blocks in their dtype, f32 with
    microbatches), `state_bytes` (what the step updates in place: params
    and optimizer state in training, the cache in decode, 0 in prefill)
    and `peak_live_bytes`, the high-water mark of bytes alive at once,
    arguments included."""
    kind: str
    mesh_shape: Dict[str, int]
    rank: int
    flops: float
    dot_flops: float
    tc_flops: float
    op_bytes: float
    launches: int
    collectives: Dict[str, Dict[str, Dict[str, int]]]
    tree_bytes: Dict[str, int]
    state_bytes: int
    peak_live_bytes: int

    def group_calls(self, group: str) -> int:
        return sum(self.collectives[group]["calls"].values())

    def group_bytes(self, group: str) -> int:
        return sum(self.collectives[group]["bytes"].values())

    @property
    def collective_bytes(self) -> int:
        """Every byte this rank hands a collective in the step."""
        return sum(self.group_bytes(g) for g in self.collectives)

    def row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors((tree,)))


def _fake_empty(tree):
    """An empty CPU tensor (fake, under the caller's FakeTensorMode) of
    every leaf's shape and dtype."""
    if isinstance(tree, dict):
        return {k: _fake_empty(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="cpu")


_ARG_NAMES = {"train": ("params", "opt_state", "batch"),
              "prefill": ("params", "batch"),
              "decode": ("params", "cache", "batch")}


def step_arguments(bundle, batch) -> List:
    """The arguments a rank of the bundle's plan calls its step with, as
    abstract ("meta") trees: the bundle's abstract params, optimizer
    state or cache cut to the rank's blocks under its specs, and the
    batch's rows (`batch`: the whole batch's abstract tree; a decode
    step's "tokens") split over the data axes where they divide, else
    whole on every rank (the reference's batch_shardings)."""
    from repro_torch.dist import sharding
    if bundle.kind == "decode" and isinstance(batch, dict):
        batch = batch["tokens"]
    plan = bundle.plan
    if plan is None:
        return list(bundle.abstract_args[:-1]) + [batch]
    args = [sharding.shard_tree(a, s, plan.mesh)
            for a, s in zip(bundle.abstract_args[:-1], bundle.in_specs)]
    return args + [sharding.shard_tree(
        batch, sharding.batch_shardings(plan, batch), plan.mesh)]


def argument_bytes(bundle, args, microbatches: int = 1
                   ) -> Tuple[Dict[str, int], int]:
    """({tree name: bytes a rank holds}, the state bytes) of
    `step_arguments`' trees: "params", "opt_state" or "cache", "batch",
    and in training "grads" (the params' blocks in their dtype, f32 with
    microbatches); the state is what the step updates in place (params
    and optimizer state in training, the cache in decode, 0 in
    prefill)."""
    from repro_torch.optim.adamw import tree_leaves
    tree_bytes = {n: _tree_bytes(t)
                  for n, t in zip(_ARG_NAMES[bundle.kind], args)}
    if bundle.kind == "train":
        tree_bytes["grads"] = sum(
            p.numel() * (4 if microbatches > 1 else p.element_size())
            for p in tree_leaves(args[0]))
    state = {"train": tree_bytes.get("params", 0)
             + tree_bytes.get("opt_state", 0),
             "decode": tree_bytes.get("cache", 0),
             "prefill": 0}[bundle.kind]
    return tree_bytes, state


def census_step(bundle, batch, *, microbatches: int = 1) -> StepCensus:
    """Count one call of a step (train/step.py's StepBundle, built by
    build_train_step, build_prefill_step or build_decode_step over a
    plan) as the rank of its plan's mesh (`launch.mesh.abstract_mesh`,
    whose collectives are counted and send nothing) would run it:
    nothing is computed and no process is started.

    `batch` is the whole batch's abstract tree (launch/specs.py: "meta"
    leaves of global shapes): for a decode step its "tokens". Every
    argument (the bundle's abstract params, optimizer state or cache, and
    the batch) is cut to the rank's block (sharding.local_shard under the
    bundle's specs, sharding.local_batch), made a fake CPU tensor, and the
    step called once under a counting dispatch mode. The CPU runs the
    plain versions in the kernels' places, so `flops`/`op_bytes` are the
    plain versions'; launch/dryrun.py adds the kernels' byte models.

    The live bytes are tracked storage by storage, and a tensor updated
    in place is one storage, so the reference's `hbm_adjusted` (CPU XLA
    has no donation: the donated buffers counted twice or three times in
    temp) has no counterpart here: `peak_live_bytes` counts each donated
    argument once. `microbatches` only sizes the grads' row (f32
    accumulators).

    Example::

        from repro_torch.analyze.census import census_step
        from repro_torch.configs.base import get_config, reduce_config
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import abstract_mesh
        from repro_torch.models.registry import build_model
        from repro_torch.train import step as step_lib
        cfg = reduce_config(get_config("qwen2-1.5b"), layers=2)
        plan = step_lib.make_plan(cfg, abstract_mesh({"model": 2}),
                                  kind="train")
        bundle, _ = step_lib.build_train_step(build_model(cfg), plan)
        c = census_step(bundle, specs.input_specs(cfg, "train_4k")["batch"])
        c.group_calls("model") > 0         # True
    """
    from repro_torch.models import layers
    plan = bundle.plan
    mesh = plan.mesh if plan is not None else None
    kind = bundle.kind
    ab = step_arguments(bundle, batch)
    tree_bytes, state = argument_bytes(bundle, ab, microbatches)
    groups = {"data": bundle.group, "model": bundle.model_group}
    before = {g: (dict(grp.counts["calls"]), dict(grp.counts["bytes"]))
              for g, grp in groups.items() if grp is not None}
    with FakeTensorMode():
        args = [_fake_empty(a) for a in ab]
        del ab
        counter = _LiveCounter()
        for t in _tensors(args):
            counter.track(t)
        grad = contextlib.nullcontext() if kind == "train" else \
            torch.no_grad()
        with counter, grad, layers.card_products():
            out = bundle(*args)
        del out
        peak = counter.peak
    collectives = {}
    for g, grp in groups.items():
        calls, nbytes = {}, {}
        if grp is not None:
            c0, b0 = before[g]
            calls = {k: v - c0.get(k, 0)
                     for k, v in grp.counts["calls"].items()
                     if v - c0.get(k, 0)}
            nbytes = {k: v - b0.get(k, 0)
                      for k, v in grp.counts["bytes"].items() if calls.get(k)}
        collectives[g] = {"calls": calls, "bytes": nbytes}
    return StepCensus(
        kind=kind,
        mesh_shape=dict(mesh.shape) if mesh is not None else {},
        rank=mesh.rank if mesh is not None else 0,
        flops=counter.flops, dot_flops=counter.dot_flops,
        tc_flops=counter.tc_flops, op_bytes=counter.op_bytes,
        launches=counter.launches, collectives=collectives,
        tree_bytes=tree_bytes, state_bytes=state, peak_live_bytes=peak)
