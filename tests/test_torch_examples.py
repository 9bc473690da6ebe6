"""The port's examples (`examples/*_torch.py`), each run with --device
cpu in a subprocess at its smallest size, from a temporary directory
(runs/ and the tune cache land there): rc 0 and the lines a user reads;
train_lm_torch's second run resumes and has nothing to do; its presets
are the reference's (`param_count()` of each equal to the JAX config's);
and --device cuda without a card raises instead of running the plain
versions.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, script, *args, timeout=240):
    # two intra-op threads: beside the suite's other workers the default
    # (one a core) oversubscribes the box
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TUNE_CACHE=str(tmp_path / "tune"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)


def _ok(res):
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    return res.stdout


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_trains_then_resumes(tmp_path):
    """--preset smoke for 4 steps with a checkpoint every 2, then the same
    command again: it resumes at step 4 and has nothing to do."""
    args = ("--preset", "smoke", "--steps", "4", "--ckpt-every", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"))
    out = _ok(_run(tmp_path, "train_lm_torch.py", *args))
    assert "model: 0.5M params" in out
    assert "done. final loss" in out and "over 4 steps this run" in out
    out = _ok(_run(tmp_path, "train_lm_torch.py", *args))
    assert "[trainer] resumed from step 4" in out
    assert "nothing to do: checkpoint already at step 4" in out


@pytest.mark.parametrize("preset", ["smoke", "20m", "100m"])
def test_train_lm_presets_are_the_references(preset):
    """Each preset's config counts the JAX config's params (the preset
    table is a copy of examples/train_lm.py's)."""
    from repro.configs.base import ModelConfig
    mod = _example("train_lm_torch")
    p = mod.PRESETS[preset]
    want = ModelConfig(
        name=f"train-lm-{preset}", family="dense", n_layers=p["n_layers"],
        d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], tie_embeddings=True, remat="none")
    got = mod.preset_config(preset)
    assert got.param_count() == want.param_count()
    assert got.tie_embeddings and got.remat == "none"


def test_quickstart(tmp_path):
    out = _ok(_run(tmp_path, "quickstart_torch.py", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path / "qs")))
    assert "registered kernels: ['flash', 'gpp', 'paged_decode', 'ssm']" \
        in out
    assert "gpp@tiny achtemp[0] =" in out and "final loss:" in out
    assert "restored step 20" in out
    assert all(f"request {i}: [" in out for i in range(3))


def test_registry_smoke(tmp_path):
    out = _ok(_run(tmp_path, "registry_smoke_torch.py", "--device", "cpu"))
    for name in ("gpp v10@tiny", "flash@64", "ssm@32",
                 "paged_decode gather@16x4"):
        assert f"  {name}: ok" in out
    assert "all kernels dispatch and match their references" in out


def test_serve_batched(tmp_path):
    out = _ok(_run(tmp_path, "serve_batched_torch.py", "--device", "cpu",
                   "--requests", "4", "--batch", "2", "--new-tokens", "4"))
    assert "served 4 requests / 16 tokens" in out
    assert "decode_steps=" in out and "occupancy=" in out
    assert all(f"  req {i}: [" in out for i in range(4))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "whisper-small"])
def test_serve_batched_tp(tmp_path, arch):
    """--tp 2 serves over two ranks whose tokens are checked equal, and
    they are --tp 1's tokens (whisper's requests carry their frames)."""
    args = ("--device", "cpu", "--requests", "3", "--batch", "2",
            "--new-tokens", "4", "--arch", arch)
    one = _ok(_run(tmp_path, "serve_batched_torch.py", *args))
    two = _ok(_run(tmp_path, "serve_batched_torch.py", *args, "--tp", "2"))
    assert "tp=2" in two and "the 2 ranks' tokens are equal" in two

    def tokens(out):
        return [ln.split("(ttft")[0] for ln in out.splitlines()
                if ln.startswith("  req ")]
    assert len(tokens(one)) == 3 and tokens(two) == tokens(one)


def test_the_card_is_required_by_default(tmp_path):
    """Without a card the default device raises: no plain version stands
    in for the card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    res = _run(tmp_path, "serve_batched_torch.py", "--requests", "1")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
