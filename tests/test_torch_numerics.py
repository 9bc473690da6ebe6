"""The port's numerics guard (`repro_torch.backend.f32_accumulation`): it
turns off the two CUDA matmul flags that would break the JAX package's
f32 accumulation (bf16 reduced-precision reductions, TF32) and gives the
caller's values back, and the port's entry points run under it whoever
calls them: the engine's step, the trainer's run, the train step, the
registry's dispatch and the model's forward. Each test sets both flags on,
records them from inside the entry point's own work (a stand-in for one
of its callees), and checks they are back on afterwards. The flags touch
only CUDA matmuls, so this runs on the CPU at a tiny size; the card test
tests/test_torch_numerics_cuda.py holds the logits."""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import backend
from repro_torch.configs.base import reduce_config
from repro_torch.kernels import api
from repro_torch.kernels.gpp import problem
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.step import build_train_step
from repro_torch.train.trainer import TrainLoopConfig, Trainer

MATMUL = torch.backends.cuda.matmul


def _flags():
    return (MATMUL.allow_bf16_reduced_precision_reduction, MATMUL.allow_tf32)


@pytest.fixture
def flags_on():
    """Both flags on for the test, the process's values back after it."""
    saved = _flags()
    MATMUL.allow_bf16_reduced_precision_reduction = True
    MATMUL.allow_tf32 = True
    yield
    MATMUL.allow_bf16_reduced_precision_reduction, MATMUL.allow_tf32 = saved


def _tiny():
    cfg = reduce_config(repro_torch.get_config("qwen2-1.5b"), layers=1,
                        d_model=64, vocab=128)
    return cfg, repro_torch.build_model(cfg)


def _recording(seen, fn):
    def spy(*args, **kwargs):
        seen.append(_flags())
        return fn(*args, **kwargs)
    return spy


def test_context_turns_both_off_and_restores(flags_on):
    with backend.f32_accumulation():
        assert _flags() == (False, False)
        with backend.f32_accumulation():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(RuntimeError):
        with backend.f32_accumulation():
            raise RuntimeError("the flags come back on an error too")
    assert _flags() == (True, True)
    MATMUL.allow_tf32 = False           # a mixed setting comes back as it was
    with backend.f32_accumulation():
        assert _flags() == (False, False)
    assert _flags() == (True, False)


def test_model_forward_runs_guarded(flags_on, monkeypatch):
    seen = []
    monkeypatch.setattr(transformer, "matmul",
                        _recording(seen, transformer.matmul))
    cfg, model = _tiny()
    params = model.init_params(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 16)))
    model.prefill(params, {"tokens": tokens})
    model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    assert seen and set(seen) == {(False, False)}
    assert _flags() == (True, True)


def test_engine_step_runs_guarded(flags_on):
    cfg, model = _tiny()
    eng = ServeEngine(cfg, model.init_params(0, device="cpu"), max_batch=2,
                      cache_len=32, device="cpu")
    seen = []
    eng._sample_rows = _recording(seen, eng._sample_rows)   # outside the model
    out = eng.run([Request(rid=0, prompt=np.arange(5), max_new_tokens=3)])
    assert len(out[0]) == 3
    assert seen and set(seen) == {(False, False)}
    assert _flags() == (True, True)


def test_trainer_and_train_step_run_guarded(flags_on, tmp_path, monkeypatch):
    cfg, model = _tiny()
    loop = TrainLoopConfig(total_steps=2, ckpt_every=2, log_every=1,
                           seq_len=16, global_batch=2,
                           ckpt_dir=str(tmp_path / "ckpt"))
    tr = Trainer(cfg, loop, device="cpu")
    seen = []
    tr.heartbeat.beat = _recording(seen, tr.heartbeat.beat)  # outside the step
    assert len(tr.run(verbose=False)["losses"]) == 2
    assert seen and set(seen) == {(False, False)}
    assert _flags() == (True, True)

    step, opt = build_train_step(model)
    params = model.init_params(0, device="cpu")
    seen.clear()
    # inside the step, after the grads (the optimizer is a frozen dataclass)
    monkeypatch.setattr(type(opt), "update", _recording(seen, type(opt).update))
    tokens = torch.zeros((2, 16), dtype=torch.long)
    step(params, opt.init(params), {"tokens": tokens, "labels": tokens})
    assert seen == [(False, False)]
    assert _flags() == (True, True)


def test_dispatch_runs_guarded(flags_on, monkeypatch):
    k = api.get_kernel("gpp")
    seen = []
    monkeypatch.setattr(k, "run", _recording(seen, k.run))
    ach, asx = api.dispatch("gpp", problem.make_inputs(problem.TINY),
                            version="v9", device="cpu")
    assert ach.shape == (problem.TINY.nw,)
    assert seen == [(False, False)]
    assert _flags() == (True, True)
