"""Quickstart: the public `repro_torch` surface end to end — the
counterpart of examples/quickstart.py. Dispatch a kernel through the
registry, train a tiny qwen2-family model for a few steps, restore its
checkpoint and serve from it. Runs on the card unless --device cpu.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

import repro_torch
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.train.trainer import TrainLoopConfig, Trainer


def kernel_demo(device):
    """The registry is the one entry point for every kernel family: list
    it, then dispatch the paper's GPP kernel at TINY size — version=None
    runs the default (v10 with its tuned config; on the CPU its plain
    version)."""
    from repro_torch.kernels.gpp import problem
    print(f"registered kernels: {repro_torch.list_kernels()}")
    ach, asx = repro_torch.dispatch("gpp", problem.make_inputs(problem.TINY),
                                    device=device)
    print(f"gpp@tiny achtemp[0] = {complex(ach.reshape(-1)[0].item()):.4f}")
    gpp = repro_torch.get_kernel("gpp")
    print(f"gpp versions: {gpp.versions[0]}..{gpp.versions[-1]} "
          f"(default {gpp.default_version}, tunable {gpp.tunable})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default="runs/quickstart_torch_ckpt")
    args = ap.parse_args()
    kernel_demo(args.device)

    cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=128,
                        vocab=256)
    loop = TrainLoopConfig(total_steps=20, ckpt_every=10, log_every=5,
                           ckpt_dir=args.ckpt_dir, seq_len=64,
                           global_batch=4, peak_lr=1e-3)
    trainer = Trainer(cfg, loop, device=args.device)
    out = trainer.run()
    if out["final_loss"] is None:
        print(f"checkpoint already at step {out['start_step']}; "
              f"skipping train")
    else:
        print(f"final loss: {out['final_loss']:.4f} "
              f"(stragglers flagged: {out['stragglers']})")

    # restore the checkpoint and serve a few batched requests
    step, state = trainer.ckpt.restore(device=args.device)
    print(f"restored step {step}")
    engine = repro_torch.ServeEngine(cfg, state["params"], max_batch=2,
                                     device=args.device)
    reqs = [repro_torch.Request(rid=i, prompt=np.arange(5 + i) % 256,
                                max_new_tokens=8)
            for i in range(3)]
    for rid, toks in engine.run(reqs).items():
        print(f"request {rid}: {toks}")


if __name__ == "__main__":
    main()
