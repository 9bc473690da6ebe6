"""The port's sharding engine (repro_torch.dist.sharding) held to the JAX
package's (repro.dist.sharding): spec_for on the reference's own cases
(tests/test_dist.py:30-98, tests/test_serve_sharded.py) and property, and
on every param and cache leaf of all six families' reduced configs, at
model axes 1-16 under every plan kind; the logical axes the port records
(ParamInit, Model.param_axes, Model.cache_axes) against the JAX model's;
the tree builders; local_shard's rank-major blocks. Pure host logic: the
meshes are stand-ins with a `shape` mapping, as the reference's fakes."""

import math
import os
import types

import pytest
import torch
from _prop import given, settings, st

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduce_config as jax_reduce_config
from repro.dist import sharding as jsh
from repro.models import registry as jreg
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.dist import sharding as tsh
from repro_torch.models.registry import build_model

FAMILIES = ("qwen2-1.5b", "deepseek-moe-16b", "rwkv6-7b", "hymba-1.5b",
            "whisper-small", "internvl2-26b")


def _fake_mesh(**axes):
    return types.SimpleNamespace(shape=dict(axes))


def _plans(sh, mesh, kind):
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    kw = {"exact": dict(tp_out_dims_only=True),
          "plain": dict(dp_axes=dp),
          "fsdp": dict(dp_axes=dp, fsdp=True),
          "kv_seq": dict(dp_axes=dp, kv_seq_shard=True),
          "ep": dict(dp_axes=dp, ep_data=True, fsdp=True)}[kind]
    return sh.ShardingPlan(mesh=mesh, **kw)


def _both(axes, shape, is_param, kind="plain", **mesh):
    m = _fake_mesh(**mesh)
    want = tuple(jsh.spec_for(_plans(jsh, m, kind), axes, shape,
                              is_param=is_param))
    got = tsh.spec_for(_plans(tsh, m, kind), axes, shape, is_param=is_param)
    return got, want


# the reference's cases: (plan kind, mesh, axes, shape, is_param, expected
# spec, or None where the reference accepts any replicated form)
REF_CASES = [
    ("plain", dict(data=16, model=16), ("d_model", "d_ff"), (1536, 8960),
     True, (None, "model")),
    ("plain", dict(data=16, model=16), ("d_model", "heads"), (1536, 1536),
     True, (None, "model")),
    ("plain", dict(data=16, model=16), ("d_model", "kv_heads"), (1536, 6),
     True, (None, None)),
    ("plain", dict(pod=2, data=16, model=16), ("batch", "seq"), (256, 4096),
     False, (("pod", "data"), None)),
    ("plain", dict(pod=2, data=16, model=16), ("batch", "seq"), (1, 4096),
     False, (None, None)),
    ("kv_seq", dict(data=16, model=16),
     ("layers", "batch", "kv_seq", "kv_heads", None), (48, 128, 32768, 8, 128),
     False, (None, "data", "model", None, None)),
    ("fsdp", dict(data=16, model=16), ("d_model", "d_ff"), (5120, 27648),
     True, None),
    ("exact", dict(model=8), ("layers", "d_model", "heads"), (2, 256, 256),
     True, (None, None, "model")),
    ("exact", dict(model=8), ("layers", "d_model", "d_ff"), (2, 256, 768),
     True, (None, None, "model")),
    ("exact", dict(model=8), ("layers", "heads", "d_model"), (2, 256, 256),
     True, (None, None, None)),
    ("plain", dict(model=8), ("layers", "heads", "d_model"), (2, 256, 256),
     True, (None, "model", None)),
    ("exact", dict(model=8), ("layers", "batch", "kv_seq", "kv_heads", None),
     (2, 4, 64, 8, 32), False, (None, None, None, "model", None)),
]


@pytest.mark.parametrize("case", range(len(REF_CASES)))
def test_spec_for_reference_cases(case):
    kind, mesh, axes, shape, is_param, expected = REF_CASES[case]
    got, want = _both(axes, shape, is_param, kind, **mesh)
    assert got == want
    if expected is not None:
        assert got == expected
    else:                      # fsdp: data and model both placed somewhere
        flat = [a for s in got if s for a in
                (s if isinstance(s, tuple) else (s,))]
        assert "data" in flat and "model" in flat


@settings(max_examples=40, deadline=None)
@given(
    dm=st.sampled_from([128, 1536, 5120, 6144]),
    dff=st.sampled_from([1408, 8960, 27648, 12345]),
    heads=st.sampled_from([2, 5, 8, 12, 16, 25, 40, 48]),
    fsdp=st.booleans(),
)
def test_spec_property_matches_reference(dm, dff, heads, fsdp):
    """The reference's property (every assigned axis divides its dim, no
    axis twice) on the port, and the port's spec equal to JAX's."""
    axes = ("d_model", "d_ff", "heads", "batch")
    shape = (dm, dff, heads * 64, 64)
    got, want = _both(axes, shape, True, "fsdp" if fsdp else "plain",
                      pod=2, data=16, model=16)
    assert got == want
    mesh = _fake_mesh(pod=2, data=16, model=16)
    used = []
    for i, s in enumerate(got):
        names = () if s is None else (s if isinstance(s, tuple) else (s,))
        div = 1
        for a in names:
            assert a not in used
            used.append(a)
            div *= mesh.shape[a]
        assert shape[i] % div == 0


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _models(arch):
    kw = dict(layers=2, d_model=128, vocab=256)
    return (build_model(reduce_config(get_config(arch), **kw)),
            jreg.build_model(jax_reduce_config(jax_get_config(arch), **kw)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_and_cache_axes_match_reference(arch):
    """Every leaf's logical axes and shape, params and cache, full width
    and reduced: the port records what the JAX model records."""
    for cfgs in ((get_config(arch), jax_get_config(arch)),
                 (reduce_config(get_config(arch), layers=2, d_model=128,
                                vocab=256),
                  jax_reduce_config(jax_get_config(arch), layers=2,
                                    d_model=128, vocab=256))):
        tm, jm = build_model(cfgs[0]), jreg.build_model(cfgs[1])
        assert tm.param_axes == {k: tuple(v) for k, v in
                                 jm.param_axes.items()}
        tshape = {k: tuple(v.shape) for k, v in
                  _flat(tm.abstract_params()).items()}
        jshape = {k: tuple(v.shape) for k, v in
                  _flat(jm.abstract_params()).items()}
        assert tshape == jshape
        assert all(v.device.type == "meta" for v in
                   _flat(tm.abstract_params()).values())
        assert tm.cache_axes() == {k: tuple(v) for k, v in
                                   jreg.cache_logical_axes(cfgs[1]).items()}
    cache = tm.init_cache(3, 64, abstract=True)
    jcache = jm.init_cache(3, 64, abstract=True)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


@pytest.mark.parametrize("kind", ("exact", "plain", "fsdp", "kv_seq", "ep"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_leaf_spec_matches_reference(arch, kind):
    """spec_for on every param and cache leaf of the reduced config, at
    model axes 1, 2, 4, 8 and 16 (with a data axis of 2 beside it for the
    dp plans): the port's spec tree equals JAX's."""
    tm, jm = _models(arch)
    tparams = _flat(tm.abstract_params())
    cache = tm.init_cache(4, 64, abstract=True)
    for tp in (1, 2, 4, 8, 16):
        axes = {"model": tp} if kind == "exact" else {"data": 2, "model": tp}
        mesh = _fake_mesh(**axes)
        tplan, jplan = _plans(tsh, mesh, kind), _plans(jsh, mesh, kind)
        for path, leaf in tparams.items():
            ax = tm.param_axes[path]
            assert tsh.spec_for(tplan, ax, leaf.shape) == tuple(
                jsh.spec_for(jplan, ax, leaf.shape)), (path, tp)
        for name, leaf in cache.items():
            ax = tm.cache_axes()[name] or (None,) * leaf.dim()
            assert tsh.spec_for(tplan, ax, leaf.shape, is_param=False) == \
                tuple(jsh.spec_for(jplan, ax, leaf.shape, is_param=False)), \
                (name, tp)


def test_tree_builders_and_serve_specs():
    """params_shardings / cache_shardings / batch_shardings give spec
    trees; serve_specs plans exact-TP with a replicated (B,) pos."""
    mesh = _fake_mesh(pod=2, data=4, model=2)
    p = tsh.ShardingPlan(mesh=mesh, dp_axes=("pod", "data"))
    bs = tsh.batch_shardings(p, {"tokens": torch.empty(256, 4096,
                                                       device="meta"),
                                 "cur_len": torch.empty((), device="meta")})
    assert bs["tokens"][0] == ("pod", "data") and bs["cur_len"] == ()
    ps = tsh.params_shardings(
        p, {"ffn/wi": ("layers", "d_model", "d_ff")},
        {"ffn": {"wi": types.SimpleNamespace(shape=(48, 5120, 27648))},
         "norm": types.SimpleNamespace(shape=(48, 5120))})
    assert ps["ffn"]["wi"] == (None, None, "model")
    assert ps["norm"] == (None, None)
    cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=384,
                        vocab=128)
    specs = tsh.serve_specs(cfg, _fake_mesh(model=2), max_batch=2,
                            cache_len=32)
    assert specs.plan.tp_out_dims_only and specs.plan.dp_axes == ()
    assert specs.cache["pos"] == () and specs.replicated == ()
    assert set(specs.cache) == {"k", "v", "pos"}
    assert specs.cache["k"] == (None, None, None, "model", None)
    # wq, wk, wv, bq, bk, bv, wi, wg split; wo, the ffn's wo, the norms
    # and the tied embedding whole
    split = [p for p, spec in _flat(specs.params).items()
             if any(e is not None for e in spec)]
    assert len(split) == 8, split
    assert specs.params["layers"]["attn"]["wo"] == (None, None, None)


def test_local_shard_rank_major_blocks():
    """local_shard cuts rank r's block, the mesh's axes rank-major in the
    order of its shape (the last axis fastest), a tuple entry's first
    name the most significant; the blocks of all ranks tile the whole."""
    from repro_torch.launch.mesh import Mesh
    t = torch.arange(8 * 6).reshape(8, 6)
    shape = {"data": 2, "model": 4}
    blocks = {}
    for rank in range(8):
        m = Mesh(shape, rank=rank, device="cpu", backend="gloo")
        assert m.coords == {"data": rank // 4, "model": rank % 4}
        blk = tsh.local_shard(t, (("data", "model"), None), m)
        assert tsh.local_shape(t.shape, (("data", "model"), None), m) == \
            tuple(blk.shape) == (1, 6)
        blocks[rank] = blk
        col = tsh.local_shard(t, ("data", None), m)
        assert torch.equal(col, t[4 * m.coords["data"]:
                                  4 * (m.coords["data"] + 1)])
    assert torch.equal(torch.cat([blocks[r] for r in range(8)]), t)
    m = Mesh({"model": 4}, rank=1, device="cpu", backend="gloo")
    with pytest.raises(ValueError):
        tsh.local_shard(torch.zeros(3, 6), ("model", None), m)


# ---------------------------------------------------------------------------
# FSDP beside a model axis: co-split leaves, the data subgroups
# ---------------------------------------------------------------------------

CO_MESH = {"data": 2, "model": 2}


class _Concat:
    """A stand-in AxesGroup over `members` (ranks, in index order): its
    all_gather concatenates what `value(rank)` gives for each member."""

    def __init__(self, members, value):
        self.members, self.value, self.size = members, value, len(members)

    def all_gather(self, t, dim):
        return torch.cat([self.value(r) for r in self.members], dim)


def _co_mesh(rank, shape=CO_MESH):
    from repro_torch.launch.mesh import Mesh
    return Mesh(shape, rank=rank, device="cpu", backend="gloo")


def _round_trip(whole, spec, shape=CO_MESH, order=("data", "model")):
    """Every rank's local_shard of `whole` under `spec`, gathered back by
    gather_tree over stand-in groups (data axes, then the model axis; or
    in `order`), with each rank's data-group gather."""
    from repro_torch.launch.mesh import axes_members
    data = tuple(a for a in shape if a != "model")
    n = math.prod(shape.values())
    local = {r: tsh.local_shard(whole, spec, _co_mesh(r, shape)).clone()
             for r in range(n)}
    d = next(i for i, e in enumerate(spec) if e is not None)

    def data_group(r):
        return _Concat(axes_members(shape, data, r), lambda q: local[q])

    def by_data(r):
        return data_group(r).all_gather(local[r], d)

    out = {}
    for r in range(n):
        model = _Concat(axes_members(shape, ("model",), r),
                        by_data if order[0] == "data" else
                        (lambda q: local[q]))
        if order[0] == "data":
            got = tsh.gather_tree({"w": local[r]}, {"w": d}, data_group(r),
                                  model_dims={"w": d}, model_group=model,
                                  parts={"w": tsh.spec_parts(spec)})["w"]
        else:           # model first: each member's local block, then data
            t = tsh.unpack_parts(model.all_gather(local[r], d), model.size,
                                 tsh.spec_parts(spec))
            got = _Concat(axes_members(shape, data, r),
                          lambda q: t).all_gather(t, d)
        out[r] = (got, by_data(r))
    return out


@pytest.mark.parametrize("shape", [CO_MESH, {"pod": 2, "data": 2,
                                             "model": 2}])
def test_co_split_leaf_round_trips_through_gather_tree(shape):
    """A leaf split over the model axis and the data axes together (model
    first, as spec_for makes it): each rank's block gathered over its
    data group is its model rank's block, and the gather over the model
    group after it (sharding.gather_tree's order) is the whole leaf, on
    every rank. The gather in the other order (the model group first)
    puts the blocks in (data, model) order: not the leaf."""
    entry = ("model",) + tuple(a for a in shape if a != "model")
    spec = (None, entry)
    whole = torch.arange(6 * 32, dtype=torch.float32).reshape(6, 32)
    for r, (got, tp_block) in _round_trip(whole, spec, shape).items():
        assert torch.equal(got, whole), r
        m = _co_mesh(r, shape).coords["model"]
        assert torch.equal(tp_block, whole[:, 16 * m:16 * (m + 1)])
    wrong = _round_trip(whole, spec, shape, order=("model", "data"))
    assert not any(torch.equal(got, whole) for got, _ in wrong.values())


def test_packed_co_split_leaf_keeps_its_parts():
    """hymba's in_proj (xs | z) under fsdp=True on {"data": 2, "model":
    2}: params_shardings gives it a PackedSpec whose last entry is
    ('model', 'data'); a rank's block gathered over its data group is the
    packed TP block (its model rank's block of xs beside its block of z,
    as TP alone lays it out), and gather_tree gives back xs | z whole.
    The rank-major block of the plain spec is another layout at ranks 1
    and 2 (z's first half and xs's second; ranks 0 and 3 hold xs's first
    quarter and z's last either way)."""
    from repro_torch.train import step as step_lib
    cfg = reduce_config(get_config("hymba-1.5b"), layers=2, d_model=64,
                        vocab=128)
    model = build_model(cfg)
    mesh = _fake_mesh(**CO_MESH)
    plan = step_lib.make_plan(cfg, mesh, kind="train", fsdp=True)
    specs = tsh.params_shardings(plan, model.param_axes,
                                 model.abstract_params(), model.param_parts)
    spec = specs["layers"]["mamba"]["in_proj"]
    assert tsh.spec_parts(spec) == 2
    assert tuple(spec) == (None, None, ("model", "data"))
    assert tsh.model_dims(plan, specs)["layers"]["mamba"]["in_proj"] == 2
    assert tsh.data_dims(plan, specs)["layers"]["mamba"]["in_proj"] == 2
    shape = model.abstract_params()["layers"]["mamba"]["in_proj"].shape
    whole = torch.randn(tuple(shape), generator=torch.Generator()
                        .manual_seed(0))
    tp_spec = tsh.PackedSpec((None, None, "model"), 2)
    for r, (got, tp_block) in _round_trip(whole, spec).items():
        assert torch.equal(got, whole), r
        m = _co_mesh(r).coords["model"]
        want = tsh.local_shard(whole, tp_spec, _fake_mesh_at(model=m))
        assert torch.equal(tp_block, want), r
        plain = tsh.local_shard(whole, tuple(spec), _co_mesh(r))
        mine = tsh.local_shard(whole, spec, _co_mesh(r))
        assert torch.equal(plain, mine) == (r in (0, 3)), r


def _fake_mesh_at(**coords):
    return types.SimpleNamespace(shape={a: 2 for a in coords}, coords=coords)


def test_model_dims_accepts_model_first_and_refuses_other_mixes():
    plan = tsh.ShardingPlan(mesh=_fake_mesh(pod=2, data=2, model=2),
                            dp_axes=("pod", "data"), fsdp=True)
    got = tsh.model_dims(plan, {"a": (None, ("model", "data")),
                                "b": (("model", "pod", "data"), None),
                                "c": (("pod", "data"), "model"),
                                "d": (None, None)})
    assert got == {"a": 1, "b": 0, "c": 1, "d": None}
    for bad, why in (((("data", "model"), None), "model axis first"),
                     ((("pod", "model"), None), "model axis first"),
                     (("model", ("model", "data")), "on dims"),
                     ((("model", "expert"), None), "only data axes")):
        with pytest.raises(NotImplementedError, match=why):
            tsh.model_dims(plan, {"w": bad})


ALL_ARCHS = FAMILIES + ("qwen2.5-32b", "codeqwen1.5-7b", "phi4-mini-3.8b",
                        "llama4-maverick-400b-a17b")
PLAN_MESHES = ({"data": 2, "model": 2}, {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16})
# leaves whose one dim the model axis and the data axes split together,
# on PLAN_MESHES (the default training plan for the three archs above 8e9
# params, fsdp=True for the rest)
CO_SPLIT = {"qwen2.5-32b": (9, 9, 9), "codeqwen1.5-7b": (9, 6, 4),
            "internvl2-26b": (4, 4, 4), "hymba-1.5b": (12, 1, 0),
            "rwkv6-7b": (6, 5, 5), "whisper-small": (9, 9, 6),
            "deepseek-moe-16b": (10, 7, 4)}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_training_plan_splits_without_refusal(arch):
    """The training plan of every config at full width on the 2-D and
    multi-pod meshes, by default and with fsdp=True: model_dims accepts
    every spec spec_for makes; data_dims refuses only a leaf split over a
    strict prefix of the data axes (FSDP on ("pod",) where ("pod",
    "data") does not divide). The co-split leaves counted as the port's
    planner counts them."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as step_lib
    cfg = get_config(arch)
    model = build_model(cfg)
    ab = model.abstract_params()
    counts = []
    for shape in PLAN_MESHES:
        big_data = tuple(a for a in ("pod", "data") if a in shape)
        for fsdp in (True, None):
            plan = step_lib.make_plan(cfg, _fake_mesh(**shape), kind="train",
                                      fsdp=fsdp)
            specs = tsh.params_shardings(plan, model.param_axes, ab,
                                         model.param_parts)
            tsh.model_dims(plan, specs)
            try:
                tsh.data_dims(plan, specs)
            except NotImplementedError:
                prefixes = [tuple(a for a in tsh._names(e) if a != "model")
                            for s in tree_leaves(specs) for e in s]
                assert any(p and p != big_data and big_data[:len(p)] == p
                           for p in prefixes)
            co = sum(any(isinstance(e, tuple) and "model" in e for e in s)
                     for s in tree_leaves(specs))
            if fsdp:
                counts.append(co)
            else:          # the default plan: FSDP above 8e9 params
                assert co == (counts[-1] if plan.fsdp else 0)
    if arch in CO_SPLIT:
        assert tuple(counts) == CO_SPLIT[arch]


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 16, 16)])
def test_subgroup_membership_matches_jax_make_mesh(shape):
    """launch.mesh.axes_members for ("pod", "data"), ("data",) and
    ("model",) on every rank against jax.make_mesh's device layout of the
    same shape (one process with 512 host devices): rank r is device r,
    and the group of r is the devices that share r's other coordinates,
    in the layout's order."""
    import json
    import subprocess
    import sys
    from repro_torch.launch.mesh import axes_members
    names = ("pod", "data", "model")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    ids = json.loads(subprocess.run(
        [sys.executable, "-c", "import jax, json, sys; print(json.dumps("
         "jax.make_mesh(tuple(json.loads(sys.argv[1])), ('pod', 'data', "
         "'model')).device_ids.tolist()))", json.dumps(shape)],
        capture_output=True, text=True, env=env, check=True,
        timeout=120).stdout)
    ids = torch.tensor(ids)
    mesh = dict(zip(names, shape))
    for r in range(math.prod(shape)):
        p, d, m = [int(x[0]) for x in torch.nonzero(ids == r).T]
        assert axes_members(mesh, ("pod", "data"), r) == tuple(
            ids[:, :, m].reshape(-1).tolist())
        assert axes_members(mesh, ("data",), r) == tuple(ids[p, :, m].tolist())
        assert axes_members(mesh, ("model",), r) == tuple(ids[p, d].tolist())
