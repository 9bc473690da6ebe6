"""Fault-tolerant training loop — the port of `repro.train.trainer` for one
device.

Wires together: model + train step (train/step.py), data pipeline
(prefetch), checkpoint manager (atomic + async + auto-resume), watchdog
(straggler detection), heartbeat. The loop is restart-idempotent: kill it
at any step, rerun the same command, and it resumes from the latest valid
checkpoint with bit-identical data order (step-keyed batches). The mesh
path (`mesh=`, FSDP) waits for the distribution slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import backend
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       TokenSource, make_stub_frontend_batch)
from repro_torch.dist.fault import HeartbeatFile, StepWatchdog, resume_or_init
from repro_torch.models.registry import build_model
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = "runs/ckpt"
    seq_len: int = 512
    global_batch: int = 8
    peak_lr: float = 3e-4
    microbatches: int = 1
    grad_compress: str = "none"
    seed: int = 0
    token_file: Optional[str] = None


class Trainer:
    """Trains `cfg` for loop.total_steps on `device` (the card unless
    device='cpu'), resuming from loop.ckpt_dir when it holds a checkpoint.

    Example::

        from repro_torch.configs.base import get_config, reduce_config
        from repro_torch.train.trainer import TrainLoopConfig, Trainer
        cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=64,
                            vocab=128)
        out = Trainer(cfg, TrainLoopConfig(total_steps=4, seq_len=32,
                                           global_batch=4),
                      device="cpu").run()
        out["losses"]
    """

    def __init__(self, cfg: ModelConfig, loop: TrainLoopConfig, mesh=None,
                 *, device=backend.DEFAULT_DEVICE):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharded training) is not ported yet: ROADMAP queue "
                "1, item 9 (distribution)")
        self.cfg = cfg
        self.loop = loop
        self.device = backend.resolve_device(device)
        self.model = build_model(cfg)
        self.step_fn, self.opt = step_lib.build_train_step(
            self.model, peak_lr=loop.peak_lr, total_steps=loop.total_steps,
            microbatches=loop.microbatches, grad_compress=loop.grad_compress)
        self.ckpt = CheckpointManager(loop.ckpt_dir)
        self.watchdog = StepWatchdog(
            on_straggler=lambda s, dt, ew: print(
                f"[watchdog] step {s} took {dt:.2f}s (ewma {ew:.2f}s) — "
                f"straggler; on a fleet this triggers re-slicing"))
        self.heartbeat = HeartbeatFile(loop.ckpt_dir)
        # {"params", "opt"} after run(): the state the last step left
        self.state: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ run

    @backend.f32_accumulation()
    def run(self, *, verbose: bool = True) -> Dict[str, Any]:
        loop = self.loop

        def init_state():
            params = self.model.init_params(loop.seed, device=self.device)
            return {"params": params, "opt": self.opt.init(params)}

        start_step, state = resume_or_init(self.ckpt, init_state,
                                           device=self.device)
        if verbose and start_step:
            print(f"[trainer] resumed from step {start_step}")

        data_cfg = DataConfig(seq_len=loop.seq_len,
                              global_batch=loop.global_batch,
                              vocab_size=self.cfg.vocab_size,
                              seed=loop.seed, token_file=loop.token_file)
        it = PrefetchIterator(TokenSource(data_cfg), start_step=start_step)

        params, opt_state = state["params"], state["opt"]
        metrics = {}
        losses = []
        try:
            for step in range(start_step, loop.total_steps):
                t0 = time.perf_counter()
                data_step, batch = next(it)
                if data_step != step:
                    raise RuntimeError(f"data step {data_step} != step {step}")
                batch = make_stub_frontend_batch(self.cfg, batch, loop.seed)
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in batch.items()}
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                losses.append(float(metrics["loss"]))    # waits for the step
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                self.heartbeat.beat(step)
                if verbose and step % loop.log_every == 0:
                    print(f"step {step:5d} loss {losses[-1]:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"{dt*1e3:.0f} ms")
                if (step + 1) % loop.ckpt_every == 0 or \
                        step + 1 == loop.total_steps:
                    self.ckpt.save(step + 1,
                                   {"params": params, "opt": opt_state})
        finally:
            it.close()
            self.ckpt.barrier()
        self.state = {"params": params, "opt": opt_state}
        return {"final_loss": losses[-1] if losses else None,
                "losses": losses,
                "start_step": start_step,
                "stragglers": self.watchdog.stragglers,
                "metrics": {k: float(v) for k, v in metrics.items()}}
