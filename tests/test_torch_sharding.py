"""The port's sharding engine (repro_torch.dist.sharding) held to the JAX
package's (repro.dist.sharding): spec_for on the reference's own cases
(tests/test_dist.py:30-98, tests/test_serve_sharded.py) and property, and
on every param and cache leaf of all six families' reduced configs, at
model axes 1-16 under every plan kind; the logical axes the port records
(ParamInit, Model.param_axes, Model.cache_axes) against the JAX model's;
the tree builders; local_shard's rank-major blocks. Pure host logic: the
meshes are stand-ins with a `shape` mapping, as the reference's fakes."""

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
