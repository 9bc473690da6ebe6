"""Timing harness for the tuner's measurement pass and the journey — the
port of `repro.tune.measure`.

Warm-up calls first, then `reps` timed calls, median reported. On the
card each call is fenced by a pair of CUDA events on the current stream
and one `torch.cuda.synchronize()` at the end (the events time the device,
not the enqueue); on the CPU each call is timed with `perf_counter`.
`time_config` is the GPP entry: `gpp_cuda` under one BlockConfig.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict

import torch


def time_callable(fn: Callable[[], object], *, device="cpu", warmup: int = 1,
                  reps: int = 3) -> float:
    """Median seconds per call of `fn` on `device`.

    warmup=0 is honored (the first timed call then includes build and
    first-launch cost); only negative values are clamped."""
    dev = torch.device(device)
    for _ in range(max(warmup, 0)):
        fn()
    reps = max(reps, 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in events:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(dev)
        times = [start.elapsed_time(end) / 1e3 for start, end in events]
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_config(inputs: Dict, cfg, *, device, warmup: int = 1,
                reps: int = 3) -> float:
    """Median seconds per call of `gpp_cuda` under the BlockConfig `cfg`
    on `inputs` (planar numpy arrays or tensors, moved to `device` once,
    outside the timed calls): the kernel on the card, its plain version on
    the CPU. `device` has no default: the caller says where the work runs.
    warmup=0 makes no warm-up call; a negative one is clamped."""
    from repro_torch.kernels.gpp import gpp_cuda, problem
    t = problem.to_tensors(inputs, device)
    return time_callable(lambda: gpp_cuda.gpp_cuda(t, cfg), device=device,
                         warmup=warmup, reps=reps)
