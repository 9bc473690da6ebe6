"""Serve a small model with batched requests through the PyTorch port —
the counterpart of examples/serve_batched.py: slot-level continuous
batching (finished slots refill from the queue mid-flight), greedy and
temperature sampling, per-request latency and throughput stats. Runs on
the card unless --device cpu.

    PYTHONPATH=src python examples/serve_batched_torch.py --requests 8 --batch 4

Tensor-parallel over --tp ranks (one process a rank over a {"model": tp}
mesh, ServeEngine(mesh=), over gloo: the ranks may share one card; the
tokens are bit-equal to --tp 1's, and every rank's are checked equal to
rank 0's). --arch serves another config at the same reduced size, any
family (whisper's requests carry their frames, internvl2's their patch
embeddings):

    PYTHONPATH=src python examples/serve_batched_torch.py --tp 2 --device cpu
    PYTHONPATH=src python examples/serve_batched_torch.py --tp 2 \\
        --arch hymba-1.5b --device cuda
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve(args, mesh=None):
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = reduce_config(get_config(args.arch), layers=4, d_model=256,
                        vocab=1024)
    params = build_model(cfg).init_params(0, device=args.device)
    engine = ServeEngine(cfg, params, max_batch=args.batch,
                         device=args.device, mesh=mesh)
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

    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 8 + i % 5),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature, extra=extra())
            for i in range(args.requests)]

    t0 = time.perf_counter()
    out, stats = engine.run(reqs, collect_stats=True)
    dt = time.perf_counter() - t0
    if mesh is not None:
        outs = [None] * mesh.size
        torch.distributed.all_gather_object(outs, out)
        if any(o != outs[0] for o in outs):
            raise RuntimeError(f"rank {mesh.rank}: the ranks' tokens differ")
        if mesh.rank != 0:
            return
    e = stats["engine"]
    total = sum(len(v) for v in out.values())
    tp = f", tp={args.tp}" if args.tp > 1 else ""
    print(f"served {len(reqs)} requests / {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s, batch={args.batch}{tp})")
    if mesh is not None:
        print(f"  the {args.tp} ranks' tokens are equal")
    for d in e.get("per_device", []):
        print(f"  device {d['device']}: params "
              f"{d['params_bytes'] / 2 ** 20:.2f} MiB, cache "
              f"{d['cache_bytes'] / 2 ** 20:.2f} MiB")
    print(f"  decode_steps={e['decode_steps']} prefills={e['prefills']} "
          f"occupancy={e['occupancy']:.2f} "
          f"mean_ttft={e['mean_ttft_s'] * 1e3:.0f}ms "
          f"mean_queue_wait={e['mean_queue_wait_s'] * 1e3:.0f}ms")
    for rid in sorted(out)[:4]:
        st = stats["requests"][rid]
        print(f"  req {rid}: {out[rid][:10]}"
              f"{'...' if len(out[rid]) > 10 else ''}"
              f"  (ttft {st.ttft_s * 1e3:.0f}ms, {st.tok_per_s:.1f} tok/s)",
              flush=True)


def rank_main(rank, store, args):
    from repro_torch.launch import ranks
    mesh = ranks.rank_mesh(rank, store, {"model": args.tp},
                           device=args.device, backend="gloo",
                           timeout_s=120)
    serve(args, mesh)
    torch.distributed.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--tp", type=int, default=1,
                    help="serve tensor-parallel over a tp-way model axis "
                         "(one process a rank)")
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    help="the config to serve, reduced to 4 layers, d_model "
                         "256, vocab 1024 (any of the port's configs)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.tp == 1:
        serve(args)
        return
    from repro_torch.launch import ranks
    ranks.spawn(rank_main, args.tp, args, prefix="serve_batched_")


if __name__ == "__main__":
    main()
