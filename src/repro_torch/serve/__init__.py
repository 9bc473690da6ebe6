"""Serving: the slot-level continuous-batching engine (engine.py). The
paged K/V cache, speculative decoding, the router and the trace
generator come in later slices."""

from repro_torch.serve.engine import (Request, RequestStats,  # noqa: F401
                                      ServeEngine, StepReport,
                                      aggregate_engine_stats)
