#!/usr/bin/env python3
"""Time gloo's collectives for ranks that share one card: each rank
stages a CUDA tensor through host memory (pageable or pinned), runs the
collective on the host copy and copies the result back, as
repro_torch.dist.collectives does for gloo on CUDA tensors.

    python3 tools/gloo_collective_probe.py [--ranks 2] [--mb 1540 400]

For each size (MB of f32 a rank) it prints, per route, the median of 3
host-clock timings (after a warm-up, the card synchronized): the copies
alone (device to host, host to device), all_reduce staged through
pageable and through pinned memory, reduce_scatter_tensor, the same
reduction as all_to_all_single plus a local sum, and
all_gather_into_tensor, with the GB/s each moves of the rank's input.
Needs a CUDA card; the ranks rendezvous through a FileStore under
build/.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(torch, fn, reps=3):
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def rank_main(rank, n, store, sizes_mb):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    for mb in sizes_mb:
        numel = (mb * 2 ** 20 // 4) // n * n
        x = torch.randn(numel, device="cuda")
        pin = torch.empty(numel, pin_memory=True)
        pin_out = torch.empty(numel, pin_memory=True)
        gath = torch.empty(numel * n, pin_memory=True)
        rows = {}

        def d2h_pageable():
            return x.to("cpu")

        def d2h_pinned():
            pin.copy_(x)

        def h2d_pinned():
            return pin.to("cuda")

        def ar_pageable():
            h = x.to("cpu")
            dist.all_reduce(h)
            return h.to("cuda")

        def ar_pinned():
            pin.copy_(x)
            dist.all_reduce(pin)
            return pin.to("cuda")

        def rs_pinned():
            pin.copy_(x)
            dist.reduce_scatter_tensor(pin_out[:numel // n], pin)
            return pin_out[:numel // n].to("cuda")

        def a2a_sum_pinned():
            pin.copy_(x)
            dist.all_to_all_single(pin_out, pin)
            return pin_out.view(n, -1).sum(0).to("cuda")

        def ag_pinned():
            pin.copy_(x)
            dist.all_gather_into_tensor(gath, pin)
            return gath.to("cuda")

        for name, fn in (("d2h pageable", d2h_pageable),
                         ("d2h pinned", d2h_pinned),
                         ("h2d pinned", h2d_pinned),
                         ("all_reduce pageable", ar_pageable),
                         ("all_reduce pinned", ar_pinned),
                         ("reduce_scatter pinned", rs_pinned),
                         ("all_to_all + sum pinned", a2a_sum_pinned),
                         ("all_gather pinned", ag_pinned)):
            dist.barrier()
            rows[name] = _timed(torch, fn)
        if rank == 0:
            gb = numel * 4 / 1e9
            print(f"[probe] {n} ranks on one card, {gb:.3f} GB of f32 a "
                  f"rank: " + "; ".join(
                      f"{k} {v * 1e3:.1f} ms ({gb / v:.2f} GB/s)"
                      for k, v in rows.items()), flush=True)
        del x, pin, pin_out, gath
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mb", type=int, nargs="+", default=[1540, 400])
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        sys.exit("gloo_collective_probe.py needs a CUDA card")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="gloo_probe_",
                            dir=os.path.join(ROOT, "build"))
    mp.spawn(rank_main, args=(args.ranks, os.path.join(work, "store"),
                              args.mb), nprocs=args.ranks)


if __name__ == "__main__":
    main()
