"""Serving tier — the port of `repro.serve`: the slot-scheduler engine,
the multi-replica DP router and the synthetic trace generator.

  * engine — ServeEngine: slot-level continuous batching (run() to
    drain, or the stepwise submit()/step()/evict_inflight() surface),
    with the paged K/V cache (kvcache.py) and speculative decoding
    (spec.py); sampling is the JAX package's Threefry stream (rng.py).
  * router — Router: DP load balancing over N replica engines with
    heartbeat failover, a deterministic FaultPlan (kill/stall/recover/
    flap), bounded-queue load shedding with retry backoff, deadlines,
    and an OverloadConfig brown-out controller.
  * trace  — seeded Poisson/bursty request traces with heavy-tail
    length (and optional deadline) mixes.
"""

from repro_torch.serve.engine import (Request, RequestStats,  # noqa: F401
                                      ServeEngine, StepReport,
                                      aggregate_engine_stats)
from repro_torch.serve.trace import (Trace, TraceConfig,  # noqa: F401
                                     TracedRequest, generate_trace)
from repro_torch.serve.router import (FaultPlan, OverloadConfig,  # noqa: F401
                                      Router)
