"""End-to-end LM training with the PyTorch port — the counterpart of
examples/train_lm.py.

Presets (the reference's, copied exactly):
    --preset 100m   12L/768d qwen2-family ~100M params
    --preset 20m    8L/384d
    --preset smoke  2L/128d

The full production path: config -> model -> train step (one device, or
--data x --model ranks, one process a rank over a {"data", "model"}
mesh) -> prefetching data pipeline -> checkpoint and auto-resume (kill it
and rerun: it continues; rerun when it is done: "nothing to do") ->
straggler watchdog. Runs on the card unless --device cpu.

    PYTHONPATH=src python examples/train_lm_torch.py --preset 20m --steps 200
    # on the CPU, 2 x 2 ranks over gloo
    PYTHONPATH=src python examples/train_lm_torch.py --preset smoke \\
        --steps 20 --device cpu --data 2 --model 2
"""

from __future__ import annotations

import argparse

import torch

PRESETS = {
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=32768, seq_len=256, batch=4),
    "20m": dict(n_layers=8, d_model=384, n_heads=6, n_kv_heads=2,
                d_ff=1024, vocab_size=16384, seq_len=256, batch=4),
    "smoke": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  d_ff=384, vocab_size=1024, seq_len=64, batch=4),
}


def preset_config(name: str):
    """The ModelConfig of a preset (tied embeddings, no remat)."""
    from repro_torch.configs.base import ModelConfig
    p = PRESETS[name]
    return ModelConfig(
        name=f"train-lm-{name}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], tie_embeddings=True, remat="none")


def train(args, mesh=None):
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    rank = 0 if mesh is None else mesh.rank
    if rank == 0:
        print(f"model: {cfg.param_count() / 1e6:.1f}M params", flush=True)
    loop = TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every, log_every=10,
        ckpt_dir=args.ckpt_dir or f"runs/train_lm_torch_{args.preset}",
        seq_len=p["seq_len"], global_batch=p["batch"], peak_lr=args.lr,
        token_file=args.token_file)
    out = Trainer(cfg, loop, mesh, device=args.device).run()
    if rank != 0:
        return
    if out["final_loss"] is None:
        print(f"nothing to do: checkpoint already at step "
              f"{out['start_step']}", flush=True)
    else:
        print(f"done. final loss {out['final_loss']:.4f} "
              f"over {len(out['losses'])} steps this run", flush=True)


def rank_main(rank, store, args):
    from repro_torch.launch import ranks
    shape = {"data": args.data, "model": args.model}
    mesh = ranks.rank_mesh(rank, store, shape, device=args.device,
                           backend="gloo")
    train(args, mesh)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--token-file", default=None,
                    help="flat binary token file (default: synthetic)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.data * args.model == 1:
        train(args)
        return
    from repro_torch.launch import ranks
    ranks.spawn(rank_main, args.data * args.model, args, prefix="train_lm_")


if __name__ == "__main__":
    main()
