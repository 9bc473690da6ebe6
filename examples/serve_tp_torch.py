"""Tensor-parallel serving with the PyTorch port: N ranks, one process
each, every rank serving the same requests through ServeEngine(mesh=)
and printing the same tokens (exact-TP: bit-equal to one device). Every
family serves under a mesh; --arch picks the config (qwen2-1.5b by
default; hymba-1.5b, rwkv6-7b, whisper-small and internvl2-26b among the
others; whisper's requests carry their frames, internvl2's their patch
embeddings).

    # on the CPU (gloo), a reduced qwen2, 2 ranks (~10 s):
    PYTHONPATH=src python examples/serve_tp_torch.py --ranks 2 --device cpu
    # the same for another family, e.g. hymba with the "pallas" scan (its
    # plain version on the CPU, the kernel on a card):
    PYTHONPATH=src python examples/serve_tp_torch.py --arch hymba-1.5b \
        --ssm-impl pallas --ranks 2 --device cpu
    # on a card: 2 ranks sharing it over gloo (NCCL needs a GPU a rank)
    PYTHONPATH=src python examples/serve_tp_torch.py --ranks 2 --device cuda \
        --arch rwkv6-7b

The ranks rendezvous through a FileStore in a temporary directory; the
mesh is ("model",) of --ranks, built by repro_torch.launch.mesh.make_mesh
with the backend named by --backend.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    cfg = repro_torch.get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, layers=2, d_model=384, vocab=512)
    if args.ssm_impl:
        cfg = dataclasses.replace(cfg, ssm_impl=args.ssm_impl)
    params = repro_torch.build_model(cfg).init_params(0, device=args.device)
    eng = repro_torch.ServeEngine(cfg, params, max_batch=2, cache_len=512,
                                  device=args.device, mesh=mesh)
    del params
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=args.device).manual_seed(0)

    def extra():
        # whisper's frames, internvl2's patch embeddings: the same on
        # every rank (one seed, drawn in the same order)
        shape = {"encdec": ("frames", cfg.enc_seq),
                 "vlm": ("vis", cfg.n_vis_tokens)}.get(cfg.family)
        if shape is None:
            return None
        return {shape[0]: (torch.randn(1, shape[1], cfg.d_model,
                                       generator=gen, device=args.device)
                           * 0.02).bfloat16()}

    reqs = [repro_torch.Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, 5 + i), max_new_tokens=8,
                temperature=0.7 * (i % 2), extra=extra())
            for i in range(4)]
    out, stats = eng.run(reqs, collect_stats=True)
    print(f"rank {rank}: {out}; per_device "
          f"{stats['engine']['per_device']}", flush=True)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="the config to serve (any of the port's configs)")
    ap.add_argument("--ssm-impl", default=None,
                    choices=("pallas", "chunked", "scan"),
                    help="the hybrid family's scan (default: the config's)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the config at full width (default: reduced "
                         "to 2 layers, d_model 384, vocab 512)")
    args = ap.parse_args()
    store = os.path.join(tempfile.mkdtemp(prefix="serve_tp_"), "store")
    torch.multiprocessing.spawn(rank_main, args=(args, store),
                                nprocs=args.ranks)


if __name__ == "__main__":
    main()
