"""The port's data pipeline and checkpoints against the JAX package's:
TokenSource batches byte-identical for synthetic data and for a token
file across ranks, PrefetchIterator order, the stub frontend batch; the
JAX checkpoint tests (tests/test_optim_ckpt_data.py:97-170) mirrored for
the port; and checkpoints across the two packages — one the port writes
restored by repro.ckpt.checkpoint.CheckpointManager and one JAX writes
restored by the port, bf16 bit-exact both ways (how state moves between
the packages). All comparisons here are exact."""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.base import get_config as jget
from repro.data import pipeline as jpipe
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.dist.fault import resume_or_init
from repro_torch.models.convert import tensor_from_numpy


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


# ---------------------------------------------------------------------- data

@pytest.mark.parametrize("dp_rank,dp_size", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_synthetic_batches_byte_identical(dp_rank, dp_size):
    kw = dict(seq_len=16, global_batch=8, vocab_size=151_936, seed=3)
    j = jpipe.TokenSource(jpipe.DataConfig(**kw), dp_rank, dp_size)
    t = tpipe.TokenSource(tpipe.DataConfig(**kw), dp_rank, dp_size)
    for step in (0, 1, 17, 1000):
        a, b = j.batch_at(step), t.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].shape == b[k].shape == (8 // dp_size, 16)
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("dp_rank,dp_size", [(0, 1), (1, 2)])
def test_token_file_batches_byte_identical(tmp_path, dp_rank, dp_size):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 60_000, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(seq_len=32, global_batch=4, vocab_size=60_000, seed=1,
              token_file=path)
    j = jpipe.TokenSource(jpipe.DataConfig(**kw), dp_rank, dp_size)
    t = tpipe.TokenSource(tpipe.DataConfig(**kw), dp_rank, dp_size)
    for step in (0, 5):
        a, b = j.batch_at(step), t.batch_at(step)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
    with pytest.raises(ValueError):
        tpipe.TokenSource(tpipe.DataConfig(**kw), 0, 3)


def test_prefetch_iterator_order():
    src = tpipe.TokenSource(tpipe.DataConfig(seq_len=8, global_batch=2,
                                             vocab_size=50, seed=7))
    it = tpipe.PrefetchIterator(src, start_step=5)
    try:
        for want in range(5, 11):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(want)["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-small",
                                  "internvl2-26b"])
def test_stub_frontend_batch_matches_jax(arch):
    src = jpipe.TokenSource(jpipe.DataConfig(seq_len=300, global_batch=2,
                                             vocab_size=100, seed=0))
    batch = src.batch_at(0)
    a = jpipe.make_stub_frontend_batch(jget(arch), dict(batch), 4)
    b = tpipe.make_stub_frontend_batch(get_config(arch), dict(batch), 4)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


# --------------------------------------------------------------- checkpoints

def _tree():
    return {"params": {"w": torch.ones((4, 3), dtype=torch.bfloat16) * 1.5,
                       "b": torch.arange(3, dtype=torch.float32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, blocking=True)
    step, restored = mgr.restore(device="cpu")
    assert step == 5
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert torch.equal(restored["params"]["b"], tree["params"]["b"])
    assert restored["opt"]["step"].shape == () and int(restored["opt"]["step"]) == 7
    manifest = json.load(open(tmp_path / "step_00000005" / "manifest.json"))
    assert manifest["leaves"]["params/w"] == {"shape": [4, 3],
                                              "dtype": "bfloat16"}


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.ones(2) * s}, blocking=True)
    assert mgr.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]  # gc kept last 2
    _, t = mgr.restore(3, device="cpu")
    assert float(t["x"][0]) == 3.0


def test_checkpoint_no_partial_visibility(tmp_path):
    """A tmp dir from a 'crashed' save must not be visible via LATEST."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(1)}, blocking=True)
    os.makedirs(os.path.join(tmp_path, ".tmp_step_00000002"))
    assert mgr.latest_step() == 1


def test_checkpoint_latest_survives_crash_before_pointer(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(1)}, blocking=True)
    mgr.save(2, {"x": torch.ones(1)}, blocking=True)
    with open(os.path.join(tmp_path, "LATEST"), "w") as fh:
        fh.write("step_00000001")
    assert mgr.latest_step() == 2
    step, t = mgr.restore(device="cpu")
    assert step == 2 and float(t["x"][0]) == 1.0
    os.remove(os.path.join(tmp_path, "LATEST"))
    assert mgr.latest_step() == 2


def test_checkpoint_latest_pointer_never_torn(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": torch.zeros(1)}, blocking=True)
    with open(os.path.join(tmp_path, "LATEST")) as fh:
        assert fh.read() == "step_00000003"
    assert [f for f in os.listdir(tmp_path)
            if f.startswith(".LATEST_")] == []
    for torn in ("step_000", ""):
        with open(os.path.join(tmp_path, "LATEST"), "w") as fh:
            fh.write(torn)
        assert mgr.latest_step() == 3


def test_async_save_snapshots_before_returning(tmp_path):
    """save() copies to host memory before it returns: an in-place update
    right after (what the optimizer does) does not reach the checkpoint;
    barrier() waits for the write; resume_or_init restores it."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(9, tree)
    tree["params"]["b"].add_(100.0)
    mgr.barrier()
    step, state = resume_or_init(mgr, lambda: None, device="cpu")
    assert step == 9
    np.testing.assert_array_equal(state["params"]["b"].numpy(), [0, 1, 2])
    assert resume_or_init(CheckpointManager(str(tmp_path / "empty")),
                          lambda: "fresh", device="cpu") == (0, "fresh")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):     # restore defaults to the card
            mgr.restore()


def _state_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"layers": {"wq": rng.standard_normal((2, 8, 4)).astype(
                           ml_dtypes.bfloat16)},
                       "final_norm": rng.standard_normal(8).astype(
                           ml_dtypes.bfloat16)},
            "opt": {"m": {"layers": {"wq": rng.standard_normal(
                        (2, 8, 4)).astype(np.float32)}},
                    "step": np.int32(12)}}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_port_checkpoint_restores_in_jax_bit_exact(tmp_path):
    state = _state_np()
    CheckpointManager(str(tmp_path)).save(12, _tree_to_torch(state),
                                          blocking=True)
    step, restored = JCheckpointManager(str(tmp_path)).restore()
    assert step == 12
    want = _flat(state)
    got = _flat(restored)
    assert set(got) == set(want)
    for path, a in want.items():
        b = np.asarray(got[path])
        assert b.dtype == np.asarray(a).dtype and b.shape == np.shape(a)
        assert b.tobytes() == np.asarray(a).tobytes(), path


def _tree_to_torch(node):
    if isinstance(node, dict):
        return {k: _tree_to_torch(v) for k, v in node.items()}
    return tensor_from_numpy(node, "cpu")


def _tree_to_jax(node):
    if isinstance(node, dict):
        return {k: _tree_to_jax(v) for k, v in node.items()}
    return jnp.asarray(node)


def test_jax_checkpoint_restores_in_port_bit_exact(tmp_path):
    state = _state_np(1)
    JCheckpointManager(str(tmp_path)).save(4, _tree_to_jax(state),
                                           blocking=True)
    step, restored = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 4
    got = _flat(restored)
    for path, a in _flat(state).items():
        t = got[path]
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            assert _bits(t).tobytes() == a.view(np.int16).tobytes(), path
        else:
            assert _bits(t).tobytes() == a.tobytes(), path
    assert got["opt/step"].dtype == torch.int32


def test_manifest_format_matches_jax(tmp_path):
    """The same state saved by both packages gives the same manifests and
    the same npz entries, byte for byte."""
    state = _state_np(2)
    CheckpointManager(str(tmp_path / "t")).save(
        1, _tree_to_torch(state), blocking=True)
    JCheckpointManager(str(tmp_path / "j")).save(
        1, _tree_to_jax(state), blocking=True)
    mt = json.load(open(tmp_path / "t" / "step_00000001" / "manifest.json"))
    mj = json.load(open(tmp_path / "j" / "step_00000001" / "manifest.json"))
    assert mt == mj
    with np.load(tmp_path / "t" / "step_00000001" / "data.npz") as zt, \
            np.load(tmp_path / "j" / "step_00000001" / "data.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype
            assert zt[k].tobytes() == zj[k].tobytes()
