"""Data-parallel training with the PyTorch port: N ranks, one process each,
every rank running Trainer(cfg, loop, mesh) over a {"data": N} mesh and
printing the same losses (the global batch's); with --model M the mesh
is {"data": N / M, "model": M}: tensor-parallel training over M ranks,
data-parallel over the rest; with --pods P as well, {"pod": P, "data": N
/ (P M), "model": M}, the data group then over ("pod", "data"). --fsdp
forces FSDP (beside a model axis too: a dim may then be split over the
model axis and the data axes together); without it the plan is the
reference's default (FSDP above 8e9 params, EP instead for moe).

    # on the CPU (gloo), a reduced qwen2, 2 ranks, DP then FSDP (~20 s):
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 2 --device cpu
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 2 --device cpu --fsdp
    # TP over 2 ranks, and DP x TP over 4; any family (--arch)
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 2 --model 2
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 4 --model 2
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 2 --model 2 \
        --arch hymba-1.5b
    # FSDP beside TP over {"data": 2, "model": 2}, and over {"pod": 2,
    # "data": 2, "model": 2} (8 ranks)
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 4 --model 2 \
        --fsdp --arch qwen2.5-32b
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 8 --model 2 \
        --pods 2 --fsdp --arch qwen2.5-32b
    # on a card: 2 ranks sharing it over gloo (NCCL needs a GPU a rank)
    PYTHONPATH=src python examples/train_dp_torch.py --ranks 2 --device cuda

The ranks rendezvous through a FileStore in a temporary directory
(repro_torch.launch.ranks; the checkpoints land in another); the mesh is
built by repro_torch.launch.mesh.make_mesh with the backend named by
--backend.
Rerun with --ckpt-dir pointing at an earlier run's directory and more
--steps to resume from its last checkpoint, with as many ranks as you
like: checkpoints hold whole leaves.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch


def rank_main(rank, store, args):
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.launch import ranks
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    shape = ranks.mesh_shape(args.ranks, model=args.model, pods=args.pods)
    mesh = ranks.rank_mesh(rank, store, shape, device=args.device,
                           backend=args.backend)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers=2, d_model=64, vocab=128)
    loop = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.steps,
                           log_every=1, ckpt_dir=args.ckpt_dir, seq_len=32,
                           global_batch=4 * shape["data"] * args.pods)
    out = Trainer(cfg, loop, mesh, fsdp=args.fsdp or None).run(
        verbose=rank == 0)
    print(f"rank {rank}: losses {out['losses']}", flush=True)
    torch.distributed.destroy_process_group()


def main():
    from repro_torch.launch import ranks
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--fsdp", action="store_true",
                    help="split params and optimizer state over the data "
                         "ranks (default: the reference's plan)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the model axis (tensor parallelism); "
                         "must divide --ranks")
    ap.add_argument("--pods", type=int, default=1,
                    help="a pod axis of this size before the data axis")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="the model (any family: qwen2-1.5b, hymba-1.5b, "
                         "rwkv6-7b, whisper-small, internvl2-26b, ...)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the model at full width (default: reduced)")
    args = ap.parse_args()
    if args.ranks % (args.model * args.pods):
        ap.error(f"--model {args.model} x --pods {args.pods} does not "
                 f"divide --ranks {args.ranks}")
    args.ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.mkdtemp(prefix="train_dp_"), "ckpt")
    ranks.spawn(rank_main, args.ranks, args, prefix="train_dp_")


if __name__ == "__main__":
    main()
