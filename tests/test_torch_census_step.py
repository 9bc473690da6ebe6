"""The whole-step census (`analyze.census.census_step`) on abstract
meshes (`launch.mesh.abstract_mesh`), and its roofline
(`core.roofline.analyze_step`).

  * the abstract mesh: no process group, `group()` the axes' names; its
    AxesGroups count every collective as a real mesh's do and return
    empty results of the right shapes;
  * every family's reduced train step over {"model": 2}, and with
    fsdp=True over {"data": 2, "model": 2} and {"pod": 2, "data": 2,
    "model": 2}: the calls and bytes the census counts over the model
    group equal `launch.predict.tp_collectives`, over the data group
    `fsdp_data_collectives`, exactly;
  * rank 0's census equals the last rank's;
  * a decode step over {"model": 2}: flash_decode_sharded's three
    all-reduces a layer counted in the model group;
  * the live bytes: a storage counted from its op to its free, an
    in-place update of an argument not counted again;
  * analyze_step's terms.
"""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analyze.census import _LiveCounter, census_step
from repro_torch.configs.base import ShapeConfig, get_config, reduce_config
from repro_torch.core import hw, roofline
from repro_torch.dist.collectives import AxesGroup
from repro_torch.launch.mesh import ABSTRACT, abstract_mesh
from repro_torch.launch.predict import fsdp_data_collectives, tp_collectives
from repro_torch.launch.specs import train_batch_specs
from repro_torch.models.registry import build_model
from repro_torch.train import step as step_lib

# the families at tests/test_torch_tp_train.py's sizes (reduced qwen2 with
# 12 q / 2 kv heads), remat "full" (the predictors' count)
FAMILIES = {
    "dense": dict(arch="qwen2-1.5b", seq=64,
                  reduce=dict(layers=2, d_model=64, vocab=128),
                  replace=dict(n_heads=12, n_kv_heads=2, head_dim=16)),
    "moe": dict(arch="deepseek-moe-16b", seq=64,
                reduce=dict(layers=2, d_model=64, vocab=128)),
    "hybrid": dict(arch="hymba-1.5b", seq=128,
                   reduce=dict(layers=2, d_model=160, vocab=127)),
    "ssm": dict(arch="rwkv6-7b", seq=64,
                reduce=dict(layers=2, d_model=128, vocab=128)),
    "encdec": dict(arch="whisper-small", seq=32,
                   reduce=dict(layers=2, d_model=128, vocab=127)),
    "vlm": dict(arch="internvl2-26b", seq=248,
                reduce=dict(layers=2, d_model=384, vocab=127)),
}
MESHES = {"tp": ({"model": 2}, False),
          "fsdp_tp": ({"data": 2, "model": 2}, True),
          "pods": ({"pod": 2, "data": 2, "model": 2}, True)}
BATCH = 4


def _cfg(family):
    f = FAMILIES[family]
    return dataclasses.replace(reduce_config(get_config(f["arch"]),
                                             **f["reduce"]),
                               remat="full", **f.get("replace", {}))


def _batch(cfg, seq, b):
    return train_batch_specs(cfg, ShapeConfig("census", seq, b, "train"))


def _train_census(family, shape, fsdp, rank=0):
    cfg = _cfg(family)
    plan = step_lib.make_plan(cfg, abstract_mesh(shape, rank=rank),
                              kind="train", fsdp=fsdp)
    bundle, _ = step_lib.build_train_step(build_model(cfg), plan)
    return cfg, plan, census_step(
        bundle, _batch(cfg, FAMILIES[family]["seq"], BATCH))


def test_abstract_mesh_collectives():
    """An abstract mesh has no process group: group() gives the axes'
    names, an AxesGroup over it none; each collective returns an empty
    tensor of its result's shape and is counted as on a real mesh (one
    call, the input's bytes)."""
    mesh = abstract_mesh({"pod": 2, "data": 2, "model": 2}, rank=5)
    assert mesh.backend == ABSTRACT and mesh.rank == 5
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    assert mesh.group(("pod", "data")) == ("pod", "data")
    assert mesh.group("model") == ("model",)
    g = AxesGroup(mesh, ("pod", "data"))
    assert (g.size, g.index, g.group) == (4, 2, ("pod", "data"))
    x = torch.ones(4, 6, dtype=torch.bfloat16)
    assert g.all_reduce(x).shape == (4, 6)
    assert g.all_gather(x, 1).shape == (4, 24)
    assert g.reduce_scatter(x, 0).shape == (1, 6)
    assert g.all_to_all(x).shape == (4, 6)
    assert g.ring_shift(x).shape == (4, 6)
    g.barrier()
    assert g.counts == {
        "calls": {k: 1 for k in ("all_reduce", "all_gather",
                                 "reduce_scatter", "all_to_all",
                                 "ring_shift")},
        "bytes": {k: 48 for k in ("all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all",
                                  "ring_shift")}}
    with pytest.raises(ValueError):
        g.reduce_scatter(torch.ones(3, 2), 0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_census_collectives_equal_the_predictors(family, mesh):
    """A rank's train step censused on the abstract mesh: its model
    group's calls and bytes equal tp_collectives', its data group's
    fsdp_data_collectives' (the moe capacity route's gathers of the
    experts and the global batch's tokens included), call for call and
    byte for byte."""
    shape, fsdp = MESHES[mesh]
    cfg, plan, c = _train_census(family, shape, fsdp)
    seq, rows = FAMILIES[family]["seq"], BATCH // plan.dp_size()
    assert (c.group_calls("model"), c.group_bytes("model")) == \
        tuple(tp_collectives(cfg, seq, rows, 2, shape=shape, fsdp=fsdp))
    if plan.dp_size() > 1:
        assert (c.group_calls("data"), c.group_bytes("data")) == \
            tuple(fsdp_data_collectives(cfg, shape, seq, rows))
    else:
        assert c.collectives["data"] == {"calls": {}, "bytes": {}}
    assert c.kind == "train" and c.state_bytes == (
        c.tree_bytes["params"] + c.tree_bytes["opt_state"])
    assert c.peak_live_bytes > c.state_bytes + c.tree_bytes["batch"]


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_rank_zero_census_equals_the_last_ranks(family):
    """Every rank of a mesh runs the same program on blocks of the same
    shapes: rank 0's census over {"pod": 2, "data": 2, "model": 2} equals
    rank 7's in every count."""
    shape, fsdp = MESHES["pods"]
    first = _train_census(family, shape, fsdp, rank=0)[2].row()
    last = _train_census(family, shape, fsdp, rank=7)[2].row()
    assert first.pop("rank") == 0 and last.pop("rank") == 7
    assert first == last


def test_decode_census_counts_flash_decode_all_reduces():
    """A decode step over {"model": 2} with the cache's seq dim split
    (kv_seq_shard): each layer's flash_decode_sharded hands the model
    group its max, l and o (3 all-reduces), beside wo's and the FFN's
    sums; the embedding's sum; q, k, v and the logits gathered. The state
    is the rank's cache, half the lines."""
    from repro_torch.launch.specs import input_specs
    cfg = _cfg("dense")
    cell = input_specs(cfg, "decode_32k")
    plan = step_lib.make_plan(cfg, abstract_mesh({"model": 2}),
                              kind="decode")
    assert plan.kv_seq_shard
    bundle = step_lib.build_decode_step(build_model(cfg), plan,
                                        cell["cache"])
    c = census_step(bundle, cell["batch"])
    layers = cfg.n_layers
    assert c.collectives["model"]["calls"] == {
        "all_reduce": 5 * layers + 1, "all_gather": 3 * layers + 1}
    b, s = cell["cache"]["k"].shape[1:3]
    line = cfg.n_kv_heads * cfg.head_dim * 2
    assert c.state_bytes == 2 * layers * b * s // 2 * line + 4
    assert c.tree_bytes["cache"] == c.state_bytes


def test_live_bytes_track_storages():
    """A new storage counts from its op until it is freed; a view or an
    in-place update of an argument adds nothing."""
    with FakeTensorMode():
        x = torch.empty(1000, dtype=torch.float32)
        counter = _LiveCounter()
        counter.track(x)
        with counter:
            y = x * 2                   # +4000
            z = y.view(10, 100)         # a view: nothing
            x.add_(1.0)                 # in place: nothing
            del y, z
            w = x + 1                   # y's storage freed first
            del w
        assert counter.peak == 8000 and counter.live == 4000


def test_analyze_step_terms():
    """analyze_step prices the census on the spec: compute at the
    customized ceiling of its FLOPs, memory as op_bytes over HBM,
    collectives as every group's bytes over NVLink, device memory the
    live high-water mark."""
    cfg, plan, c = _train_census("dense", {"data": 2, "model": 2}, True)
    spec = hw.H100_SXM5
    rep = roofline.analyze_step("dense", c, spec=spec, model_flops_total=1e9)
    ceil = roofline.customized_ceiling(c.flops, c.tc_flops, spec)
    assert rep.compute_s == pytest.approx(c.flops / ceil, rel=1e-12)
    assert rep.memory_s == pytest.approx(c.op_bytes / spec.hbm_bw,
                                         rel=1e-12)
    assert rep.collective_s == pytest.approx(
        c.collective_bytes / spec.link_bw, rel=1e-12)
    assert rep.device_memory_bytes == c.peak_live_bytes
    assert rep.chips == 4 and rep.model_flops_total == 1e9
    assert sum(rep.extra["collective_count_by_kind"].values()) == \
        c.group_calls("data") + c.group_calls("model")
