#!/usr/bin/env python3
"""Serve one model exact-TP over a 2-rank "model" mesh from each of
several checkouts of this repo in turn, and print for each a decode
round's launches a rank, the peak device memory a rank while serving, a
decode round's ms a rank and a digest of the tokens.

    python3 tools/tp_serve_compare.py --tree build/parent --tree . \\
        --tree . --tree build/parent [--arch qwen2-1.5b] [--layers 8]

Each tree runs in a process of its own with that tree's src/ first on
the path (its kernels built from its csrc/ under its build/), so two
commits' engines meet the same card in one call: give the parent and
the change as parent, change, change, parent. The model is --arch at
full width cut to --layers layers with flash on, params from seed 0,
max_batch 4, cache_len 1024; nine greedy prompts of 16 new tokens (the
256- and 512-token ones launch flash_fwd). A round's launches are the
cudaLaunchKernel calls of three decode rounds under torch.profiler over
three; the peak is torch.cuda.max_memory_allocated from the engine's
construction (the whole params freed) to the end. Both ranks share
cuda:0 over gloo, so a round's ms is not a TP speed. Needs a card.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

PROMPTS = (256, 512, 40, 100, 256, 512, 64, 200, 300)
NEW_TOKENS = 16
TIMED_ROUNDS = 8


def rank_main(rank, n, store, out_dir, arch, n_layers):
    """One rank: its mesh, the sharded engine, the prompts served (the
    tokens' digest), three decode rounds profiled and eight timed."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import Request, ServeEngine
    torch.cuda.set_device(0)
    mesh = make_mesh({"model": n}, device="cuda:0", backend="gloo",
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=600)
    cfg = dataclasses.replace(repro_torch.get_config(arch), n_layers=n_layers,
                              use_flash_attention=True)
    params = repro_torch.build_model(cfg).init_params(0, device="cuda:0")
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024,
                      device="cuda:0", mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=p),
                    max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(PROMPTS)]
    eng.run(reqs)                                   # warm-up
    out = eng.run(reqs)
    digest = hashlib.sha1(json.dumps(
        {str(k): [int(t) for t in v] for k, v in sorted(out.items())}
    ).encode()).hexdigest()
    eng.reset()
    for r in reqs[:4]:
        eng.submit(Request(rid=r.rid, prompt=r.prompt,
                           max_new_tokens=NEW_TOKENS))
    eng.step()                                      # the admissions
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel") / 3
    ms = []
    for _ in range(TIMED_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res = {"rank": rank, "tokens_sha1": digest,
           "launches_per_round": launches,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "params_bytes": eng.device_stats()[rank]["params_bytes"],
           "decode_ms_p50": statistics.median(ms)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def one_tree(tree, arch, n_layers, ranks):
    """The ranks' results for `tree` (run in a process whose path starts
    at tree/src)."""
    import torch.multiprocessing as mp

    from repro_torch.kernels import _build
    _build.build_all()
    work = tempfile.mkdtemp(prefix="tp_compare_",
                            dir=os.path.join(tree, "build"))
    store, out_dir = os.path.join(work, "store"), os.path.join(work, "out")
    os.makedirs(out_dir)
    mp.start_processes(rank_main, args=(ranks, store, out_dir, arch,
                                        n_layers),
                       nprocs=ranks, join=True, start_method="spawn")
    res = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
           for r in range(ranks)]
    print(json.dumps({"tree": tree, "ranks": res}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout of this repo (repeat; in run order)")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_tree(os.path.abspath(args.tree[0]), args.arch, args.layers,
                 args.ranks)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for tree in args.tree:
        tree = os.path.abspath(tree)
        os.makedirs(os.path.join(tree, "build"), exist_ok=True)
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--tree",
             tree, "--arch", args.arch, "--layers", str(args.layers),
             "--ranks", str(args.ranks)], env=env, capture_output=True,
            text=True)
        if run.returncode:
            sys.exit(f"{tree}: exit {run.returncode}\n{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])["ranks"]
        print(f"{tree}: {args.arch} at {args.layers} layers over "
              f"{args.ranks} ranks: launches a decode round a rank "
              f"{[r['launches_per_round'] for r in res]}; peak a rank while "
              f"serving {[r['peak_bytes'] for r in res]} B; params a rank "
              f"{[r['params_bytes'] for r in res]} B; decode round p50 "
              f"{[round(r['decode_ms_p50'], 2) for r in res]} ms (ranks "
              f"sharing one card over gloo: not a TP speed); tokens sha1 "
              f"{sorted({r['tokens_sha1'] for r in res})}; "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


if __name__ == "__main__":
    main()
