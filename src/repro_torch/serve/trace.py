"""Synthetic request traces for serving benchmarks and chaos tests — a
copy of `repro.serve.trace` (numpy only) that builds the port's
`Request`: the same config gives the identical trace in both packages.

The router tier is gated on tail latency under bursty load, so the load
itself must be reproducible: `generate_trace(TraceConfig(...))` derives
every arrival time, prompt, length, and temperature from one
`np.random.default_rng(seed)` stream in a fixed draw order — the same
config produces the identical trace on every host, forever (pinned by
tests/test_router_props.py, and against the JAX package by
tests/test_torch_router.py).

Two arrival processes:

  * "poisson"  — homogeneous Poisson arrivals: i.i.d. exponential gaps at
    `rate_rps` requests per (virtual) second.
  * "bursty"   — a piecewise-constant-rate Poisson approximation of flash
    crowds: the base rate multiplies by `burst_factor` inside periodic
    burst windows ([k*burst_every_s, +burst_len_s) for k >= 1; the first
    period stays calm so the system has a measured steady state to
    compare the burst against). Each gap is drawn at the rate in effect
    at the previous arrival — the standard discretization, good enough
    for load shaping. The windows are recorded on the Trace so the bench
    can report goodput-under-burst.

Lengths are heavy-tailed: prompt and output lengths draw from a discrete
lognormal (median `*_median`, shape `*_sigma`) clipped to [1, `*_max`] —
a few long requests among many short ones, the mix that makes slot-level
continuous batching matter. Times are VIRTUAL seconds: the router maps
them onto scheduler ticks (`Trace.arrival_ticks`), so trace time never
touches the wall clock and every derived scheduling decision is
deterministic.

Deadlines (optional): with `deadline_median > 0` every request also draws
a heavy-tail completion deadline — a slack in ROUTER TICKS after its
arrival tick (`TracedRequest.deadline_ticks`). The router evicts a
request that has not completed within its slack and counts it
`deadline_missed` (docs/serving.md §Overload & recovery). The draw comes
last in the per-request order, and only when enabled, so pre-deadline
traces remain bit-identical per seed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine import Request


@dataclasses.dataclass
class TraceConfig:
    """Knobs for one synthetic trace (see module docstring).

    Example::

        from repro_torch.serve.trace import TraceConfig, generate_trace
        tr = generate_trace(TraceConfig(n_requests=16, arrival="bursty",
                                        seed=7))
        assert tr.requests[0].t_arrival < tr.requests[-1].t_arrival
    """
    n_requests: int = 32
    arrival: str = "poisson"          # "poisson" | "bursty"
    rate_rps: float = 8.0             # mean arrivals per virtual second
    burst_factor: float = 6.0         # bursty: rate multiplier in a window
    burst_every_s: float = 4.0        # bursty: window period
    burst_len_s: float = 1.0          # bursty: window length
    prompt_median: int = 8            # lognormal median prompt length
    prompt_sigma: float = 0.6
    prompt_max: int = 64
    out_median: int = 8               # lognormal median max_new_tokens
    out_sigma: float = 0.8
    out_max: int = 48
    temperatures: Tuple[float, ...] = (0.0,)   # sampled per request
    vocab: int = 128
    seed: int = 0
    # Optional per-request deadlines, denominated directly in ROUTER TICKS
    # of slack after arrival (independent of the tick_s mapping, so a
    # trace's deadline pressure is identical at any tick granularity).
    # deadline_median=0 (the default) disables deadlines entirely — no rng
    # draw happens, so pre-deadline traces stay bit-identical per seed.
    # When enabled, each request draws a discrete-lognormal slack
    # (heavy-tail: a few patient requests among many impatient ones),
    # clipped to [deadline_min, deadline_max].
    deadline_median: int = 0          # median slack in ticks; 0 = off
    deadline_sigma: float = 0.6
    deadline_min: int = 1
    deadline_max: int = 10_000
    # Optional shared system prompts (paged K/V prefix reuse — serve/
    # kvcache.py): with shared_prefix_frac > 0, a pool of `prefix_pool`
    # fixed prefixes of length `prefix_len` is drawn up front, and each
    # request prepends one pool member with probability shared_prefix_frac.
    # All draws happen only when enabled (and AFTER the deadline draw), so
    # pre-knob traces stay bit-identical per seed.
    shared_prefix_frac: float = 0.0   # P(request carries a pool prefix)
    prefix_pool: int = 4              # number of distinct shared prefixes
    prefix_len: int = 16              # tokens per shared prefix


@dataclasses.dataclass
class TracedRequest:
    """One request plus its virtual arrival time (seconds from t=0) and,
    optionally, a completion deadline: the request must finish within
    `deadline_ticks` router ticks of its arrival tick or be evicted and
    counted `deadline_missed` (None = no deadline)."""
    t_arrival: float
    request: Request
    deadline_ticks: Optional[int] = None


@dataclasses.dataclass
class Trace:
    cfg: TraceConfig
    requests: List[TracedRequest]               # ordered by t_arrival
    burst_windows: List[Tuple[float, float]]    # [) intervals, maybe empty

    def arrival_ticks(self, tick_s: float) -> List[int]:
        """Each request's arrival quantized onto the router's tick grid
        (floor: a request arriving inside tick k is visible at tick k)."""
        return [int(tr.t_arrival // tick_s) for tr in self.requests]

    def burst_ticks(self, tick_s: float, horizon: int) -> set:
        """The tick indices (< horizon) covered by a burst window."""
        out = set()
        for t0, t1 in self.burst_windows:
            for k in range(int(t0 // tick_s),
                           min(int(math.ceil(t1 / tick_s)), horizon)):
                out.add(k)
        return out

    def plain_requests(self) -> List[Request]:
        """The requests stripped of arrival times — the undisturbed
        single-engine baseline workload for chaos comparisons."""
        return [tr.request for tr in self.requests]

    def max_request_len(self) -> int:
        """Largest prompt_len + max_new_tokens in the trace: the minimum
        cache_len an engine needs to admit every request."""
        return max(len(tr.request.prompt) + tr.request.max_new_tokens
                   for tr in self.requests)


def _in_burst(t: float, cfg: TraceConfig) -> bool:
    if cfg.arrival != "bursty":
        return False
    phase = t % cfg.burst_every_s
    return t >= cfg.burst_every_s and phase < cfg.burst_len_s


def _lognormal_len(rng: np.random.Generator, median: int, sigma: float,
                   max_len: int) -> int:
    draw = rng.lognormal(mean=math.log(max(median, 1)), sigma=sigma)
    return int(np.clip(round(draw), 1, max_len))


def generate_trace(cfg: TraceConfig) -> Trace:
    """Derive the whole trace from one seeded generator (fixed draw order
    per request: gap, prompt length, prompt tokens, output length,
    temperature, then the opt-in deadline and shared-prefix draws) —
    per-seed determinism is part of the contract.

    Example::

        from repro_torch.serve.trace import TraceConfig, generate_trace
        a = generate_trace(TraceConfig(n_requests=8, seed=3))
        b = generate_trace(TraceConfig(n_requests=8, seed=3))
        assert [r.t_arrival for r in a.requests] \\
            == [r.t_arrival for r in b.requests]
    """
    if cfg.arrival not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {cfg.arrival!r} "
                         "(expected 'poisson' or 'bursty')")
    rng = np.random.default_rng(cfg.seed)
    # shared system prompts (drawn up front, only when enabled): requests
    # that pick the same pool member carry an identical token prefix, the
    # workload shape the paged K/V prefix index exists for. The prefix is
    # PREPENDED to the drawn prompt, so prompt lengths grow by prefix_len
    # for participating requests (size cache_len accordingly).
    # the prefix draws come from a DERIVED stream ([seed, 1]): turning the
    # knob on prepends prefixes but leaves every arrival time, length,
    # temperature, and deadline of the base trace bit-identical, so a
    # shared-prompt bench row is an apples-to-apples cold-vs-warm compare.
    prefixes = None
    prng = None
    if cfg.shared_prefix_frac > 0:
        prng = np.random.default_rng([cfg.seed, 1])
        prefixes = [prng.integers(0, cfg.vocab, cfg.prefix_len)
                    .astype(np.int32) for _ in range(cfg.prefix_pool)]
    reqs: List[TracedRequest] = []
    t = 0.0
    for rid in range(cfg.n_requests):
        rate = cfg.rate_rps * (cfg.burst_factor if _in_burst(t, cfg)
                               else 1.0)
        # np.random.Generator.exponential returns > 0, so arrival times
        # are strictly increasing (the monotonicity property)
        t += float(rng.exponential(1.0 / rate))
        plen = _lognormal_len(rng, cfg.prompt_median, cfg.prompt_sigma,
                              cfg.prompt_max)
        prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        n_out = _lognormal_len(rng, cfg.out_median, cfg.out_sigma,
                               cfg.out_max)
        temp = float(rng.choice(np.asarray(cfg.temperatures, np.float64)))
        # the deadline draw comes LAST and only when enabled, so traces
        # generated before the knob existed stay bit-identical per seed
        deadline = None
        if cfg.deadline_median > 0:
            deadline = max(cfg.deadline_min,
                           _lognormal_len(rng, cfg.deadline_median,
                                          cfg.deadline_sigma,
                                          cfg.deadline_max))
        # shared-prefix draws use the derived stream, never the base one
        if prefixes is not None and float(prng.random()) < cfg.shared_prefix_frac:
            pid = int(prng.integers(cfg.prefix_pool))
            prompt = np.concatenate([prefixes[pid], prompt])
        reqs.append(TracedRequest(
            t_arrival=t,
            request=Request(rid=rid, prompt=prompt, max_new_tokens=n_out,
                            temperature=temp),
            deadline_ticks=deadline))
    windows: List[Tuple[float, float]] = []
    if cfg.arrival == "bursty" and reqs:
        horizon = reqs[-1].t_arrival
        k = 1
        while k * cfg.burst_every_s <= horizon:
            t0 = k * cfg.burst_every_s
            windows.append((t0, t0 + cfg.burst_len_s))
            k += 1
    return Trace(cfg=cfg, requests=reqs, burst_windows=windows)
