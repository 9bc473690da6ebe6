"""Fault-tolerant training loop — the port of `repro.train.trainer`
(:44-130).

Wires together: model + train step (train/step.py), data pipeline
(prefetch), checkpoint manager (atomic + async + auto-resume), watchdog
(straggler detection), heartbeat. The loop is restart-idempotent: kill it
at any step, rerun the same command, and it resumes from the latest valid
checkpoint with bit-identical data order (step-keyed batches).

With `mesh=` (launch/mesh.make_mesh, one process a rank) every rank runs
this loop under the training plan (`step.make_plan`: DP, FSDP with
`fsdp=True` or above 8e9 params (moe takes EP instead), EP for moe, and
TP over a model axis larger than 1 for every family: row-parallel
attention, FFNs, mamba and rwkv mixes, the experts' d_ff split by
`moe_ffn_ep`'s has_tp branch, a vocab-parallel embedding and loss where
the vocab splits; FSDP beside TP, where one dim may be split over the
model axis and the data axes together, on 2-D and ("pod", "data",
"model") meshes, the data group then a subgroup a model coordinate): it
draws the whole init from the seed and keeps its blocks, builds the
global batch (the stub frontend inputs included) and keeps its rows (the
ranks of a model group the same rows). The losses are the global
batch's, equal on every rank; rank 0 prints and writes checkpoints
(whole leaves, gathered over the data axes and then the model axis; the
others wait at a barrier), each rank beats its own heartbeat
(HEARTBEAT.rank<r>), and a resume cuts each rank's blocks from the whole
leaves, whatever mesh wrote them (the elastic reshard: a checkpoint of
FSDP x TP, TP, DP x TP or one device restores into any of them; a packed
leaf, mamba's in_proj, is whole in the checkpoint and cut into its packed
layout again on restore).
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
from repro_torch.dist import sharding
from repro_torch.dist.collectives import AxesGroup
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
                 *, fsdp: Optional[bool] = None,
                 device=backend.DEFAULT_DEVICE):
        self.cfg = cfg
        self.loop = loop
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else backend.resolve_device(device))
        self.rank = 0 if mesh is None else mesh.rank
        self.model = build_model(cfg)
        self.plan = (None if mesh is None else
                     step_lib.make_plan(cfg, mesh, kind="train", fsdp=fsdp))
        self.bundle, self.opt = step_lib.build_train_step(
            self.model, self.plan, peak_lr=loop.peak_lr,
            total_steps=loop.total_steps, microbatches=loop.microbatches,
            grad_compress=loop.grad_compress)
        self.step_fn = self.bundle          # what run() calls each step
        self.ckpt = CheckpointManager(loop.ckpt_dir)
        self.watchdog = StepWatchdog(
            on_straggler=lambda s, dt, ew: print(
                f"[watchdog] step {s} took {dt:.2f}s (ewma {ew:.2f}s) — "
                f"straggler; on a fleet this triggers re-slicing"))
        self.heartbeat = HeartbeatFile(
            loop.ckpt_dir, "HEARTBEAT" if mesh is None or mesh.size == 1
            else f"HEARTBEAT.rank{mesh.rank}")
        # {"params", "opt"} after run(): the state the last step left (this
        # rank's blocks under a mesh)
        self.state: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ sharding

    def _specs(self):
        """{"params", "opt"} spec trees (None without a mesh)."""
        if self.plan is None:
            return None
        return {"params": self.bundle.in_specs[0],
                "opt": self.bundle.in_specs[1]}

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Checkpoint `state` as whole leaves. Under a mesh every rank
        takes part in the gathers (leaf by leaf, over the data axes then
        the model axis, to the host: sharding.gather_tree), rank 0 writes
        (blocking), and the others wait for it at a barrier of every
        rank."""
        if self.plan is None:
            self.ckpt.save(step, state)
            return
        specs = self._specs()
        whole = sharding.gather_tree(
            state, sharding.data_dims(self.plan, specs), self.bundle.group,
            device="cpu", model_dims=sharding.model_dims(self.plan, specs),
            model_group=self.bundle.model_group,
            parts=sharding.packed_parts(specs))
        if self.rank == 0:
            self.ckpt.save(step, whole, blocking=True)
        del whole
        AxesGroup(self.mesh, self.mesh.axis_names).barrier()

    # ------------------------------------------------------------------ run

    @backend.f32_accumulation()
    def run(self, *, verbose: bool = True) -> Dict[str, Any]:
        loop = self.loop
        verbose = verbose and self.rank == 0
        specs = self._specs()

        def init_state():
            params = self.model.init_params(loop.seed, device=self.device)
            if specs is not None:
                params = sharding.shard_tree(params, specs["params"],
                                             self.mesh)
            return {"params": params, "opt": self.opt.init(params)}

        start_step, state = resume_or_init(self.ckpt, init_state,
                                           device=self.device,
                                           shardings=specs, mesh=self.mesh)
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
                batch = {k: torch.from_numpy(v) for k, v in batch.items()}
                if self.plan is not None:
                    batch = sharding.local_batch(self.plan, batch)
                batch = {k: v.to(self.device) for k, v in batch.items()}
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
                    self.save(step + 1, {"params": params, "opt": opt_state})
        finally:
            it.close()
            self.ckpt.barrier()
        self.state = {"params": params, "opt": opt_state}
        return {"final_loss": losses[-1] if losses else None,
                "losses": losses,
                "start_step": start_step,
                "stragglers": self.watchdog.stragglers,
                "metrics": {k: float(v) for k, v in metrics.items()}}
