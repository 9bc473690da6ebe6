"""Tensor-parallel serving with the PyTorch port: N ranks, one process
each, every rank serving the same requests through ServeEngine(mesh=)
and printing the same tokens (exact-TP: bit-equal to one device).

    # on the CPU (gloo), a reduced qwen2, 2 ranks (~10 s):
    PYTHONPATH=src python examples/serve_tp_torch.py --ranks 2 --device cpu
    # on a card: 2 ranks sharing it over gloo (NCCL needs a GPU a rank)
    PYTHONPATH=src python examples/serve_tp_torch.py --ranks 2 --device cuda

The ranks rendezvous through a FileStore in a temporary directory; the
mesh is ("model",) of --ranks, built by repro_torch.launch.mesh.make_mesh
with the backend named by --backend.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def rank_main(rank, args, store):
    import repro_torch
    from repro_torch.configs.base import reduce_config
    from repro_torch.launch.mesh import make_mesh
    if args.device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    mesh = make_mesh({"model": args.ranks}, device=args.device,
                     backend=args.backend, init_method=f"file://{store}",
                     rank=rank, world_size=args.ranks, timeout_s=120)
    cfg = repro_torch.get_config("qwen2-1.5b")
    if args.reduced:
        cfg = reduce_config(cfg, layers=2, d_model=384, vocab=512)
    params = repro_torch.build_model(cfg).init_params(0, device=args.device)
    eng = repro_torch.ServeEngine(cfg, params, max_batch=2, cache_len=128,
                                  device=args.device, mesh=mesh)
    del params
    rng = np.random.default_rng(0)
    reqs = [repro_torch.Request(rid=i, prompt=rng.integers(0, 512, 5 + i),
                                max_new_tokens=8, temperature=0.7 * (i % 2))
            for i in range(4)]
    out, stats = eng.run(reqs, collect_stats=True)
    print(f"rank {rank}: {out}; per_device "
          f"{stats['engine']['per_device']}", flush=True)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="qwen2-1.5b at full width (default: reduced)")
    args = ap.parse_args()
    store = os.path.join(tempfile.mkdtemp(prefix="serve_tp_"), "store")
    torch.multiprocessing.spawn(rank_main, args=(args, store),
                                nprocs=args.ranks)


if __name__ == "__main__":
    main()
