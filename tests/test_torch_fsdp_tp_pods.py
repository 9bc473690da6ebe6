"""FSDP beside a model axis on a mesh with two data axes: one 8-rank gloo
world on the CPU over {"pod": 2, "data": 2, "model": 2}
(tests/_torch_tp_worker.run_world, the cases in
tests/_torch_tp_train_worker.py, 1 intra-op thread a rank), for what no
4-rank mesh shows. The data group is then a subgroup over ("pod",
"data"), one a model coordinate, which launch.mesh.make_mesh builds on
every rank; a co-split leaf's dim is ('model', 'pod', 'data').

  (a) AxesGroup over ("pod", "data") on every rank: its members against
      launch.mesh.axes_members, and all_reduce, all_gather and
      reduce_scatter against the same sums and concatenations made here
      from every rank's input (integer-valued, so exact);
  (b) two FSDP x TP steps of reduced qwen2.5-32b (Adafactor, 10 heads
      and 2 kv heads of 16; fsdp=True: the reduced model is under 8e9
      params) on 4 global rows, one a data rank: its plan co-splits
      leaves over ('model', 'pod', 'data'), every rank computes the same
      metrics, and the losses hold to the port's one-device step within
      tests/test_torch_tp_train.py's LOSS_ATOL, its step-0 grad norm
      within its GRAD_RTOL.

The world takes ~30-40 s (8 ranks starting beside the other test
workers)."""

import numpy as np
import pytest

import _torch_dp_worker as D
import _torch_tp_train_worker as TW
import _torch_tp_worker as W
from repro_torch.launch.mesh import axes_members

SHAPE = {"pod": 2, "data": 2, "model": 2}
LOSS_ATOL = 5e-3
GRAD_RTOL = 3e-2
OPS_SHAPE = (4, 3)
QWEN25 = dict(arch="qwen2.5-32b", reduce=dict(layers=2, d_model=64,
                                              vocab=128), seed=3,
              replace=dict(n_heads=10, n_kv_heads=2, head_dim=16),
              fsdp=True)


def _batch(seed, b=4, s=32, vocab=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :7] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


BATCHES = [_batch(0), _batch(1)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [("pod_groups", {"shape": OPS_SHAPE, "threads": 1}),
             ("tp_step:qwen25", dict(QWEN25, batches=BATCHES, threads=1))]
    return W.run_world(tmp_path_factory.mktemp("pods"), 8, cases,
                       shape=SHAPE, module="_torch_tp_train_worker")


def test_pod_data_group_sums_as_local_reductions(world):
    inputs = {r: TW.rank_tensor(r, OPS_SHAPE).numpy() for r in range(8)}
    for r in range(8):
        got = world[r]["pod_groups"]
        members = axes_members(SHAPE, ("pod", "data"), r)
        assert tuple(got["members"]) == members
        assert got["size"] == 4 and got["index"] == members.index(r)
        np.testing.assert_array_equal(got["all_reduce"],
                                      sum(inputs[q] for q in members))
        np.testing.assert_array_equal(
            got["all_gather"],
            np.concatenate([inputs[q] for q in members], 1))
        whole = sum(inputs[q] for q in members)
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      whole[got["index"]:got["index"] + 1])
        assert got["counts"]["calls"] == {"all_reduce": 1, "all_gather": 1,
                                          "reduce_scatter": 1}


def test_fsdp_tp_steps_over_pods_match_one_device(world):
    got = world[0]["tp_step:qwen25"]
    co = [k for k, spec in got["specs"].items()
          if ("model", "pod", "data") in spec]
    assert "embed" in co and "layers/ffn/wi" in co, got["specs"]
    for r in range(1, 8):
        assert [s["metrics"] for s in world[r]["tp_step:qwen25"]["steps"]] \
            == [s["metrics"] for s in got["steps"]]
    ref = D.dp_step(None, dict(QWEN25, batches=BATCHES))
    np.testing.assert_allclose(
        [s["metrics"]["loss"] for s in got["steps"]],
        [s["metrics"]["loss"] for s in ref["steps"]], atol=LOSS_ATOL, rtol=0)
    g, want = (got["steps"][0]["metrics"]["grad_norm"],
               ref["steps"][0]["metrics"]["grad_norm"])
    assert abs(g - want) <= GRAD_RTOL * want
