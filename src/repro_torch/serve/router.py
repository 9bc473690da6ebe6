"""Multi-replica DP router: trace-driven load balancing over ServeEngines
with heartbeat failover, admission control, and replica recovery — the
port of `repro.serve.router` (host logic, the JAX package's exactly).

`Router` owns N `ServeEngine`s (data-parallel: same config, one params
tree on the device shared by every replica, independent slot pools) and
drives them with the engine's stepwise API on a deterministic virtual
clock:

  one tick = one scheduler round (admission + one batched decode step)
  on every healthy replica.

Per tick, in order: apply `FaultPlan` events (kill / stall / recover),
admit due retries and trace arrivals through the bounded-queue shed
policy, sweep deadline-expired requests out of the queue and the
in-flight slots, check replica heartbeats and fence stale replicas
(re-queuing their in-flight work), dispatch the router queue
least-loaded-first, then step every healthy replica (which also beats
its heartbeat). Because arrivals, dispatch, admission, shedding, retry
backoff, and sampling are all functions of the trace seed and the tick
counter — never the wall clock — every token, queue-depth sample, and
tick-denominated latency is reproducible, which is what lets chaos tests
assert exact outcomes and lets `report.py --compare` gate tail-latency
rows across machines.

Terminal outcomes — every request ends in EXACTLY ONE of:

  * `completed`       — full output produced; bit-exact vs an undisturbed
                        single-engine run (per-request fold_in(rid, i)
                        sample keys make retries and failover safe);
  * `shed`            — rejected by admission control (bounded queue or
                        overload brown-out) with its retry budget spent;
  * `deadline_missed` — its `deadline_ticks` slack expired before
                        completion; evicted from the queue or mid-flight
                        (`ServeEngine.evict_inflight(rids=...)`), partial
                        tokens counted as waste.

Overload model (docs/serving.md §Overload & recovery):

  * `max_queue` bounds the router admission queue. A full queue sheds
    deterministically: "reject-newest" (default) refuses the arriving
    request; "reject-oldest" sheds the head of the queue to admit it.
  * A shed request with retry budget left re-enters after an exponential
    backoff in ticks (`dist.fault.backoff_ticks`); budget exhausted means
    terminal `shed`.
  * An optional windowed `OverloadConfig` controller brown-outs
    admissions under sustained pressure (queue depth above `queue_high`
    for a full window, or windowed p99 admission-TTFT above
    `ttft_p99_high`) and restores once the queue drains to `queue_low`.
    Fence-evicted work is exempt from admission control — it was already
    admitted once and re-enters at the FRONT of the queue.

Failure model (wired through repro_torch.dist.fault):

  * Every replica owns a `HeartbeatFile` and beats its current tick each
    healthy round — the same liveness file the training watchdog uses.
  * The router reads each beat and declares a replica DEAD when its last
    beaten tick lags more than `stale_after_ticks` behind (tick-lag
    staleness: the deterministic analogue of `HeartbeatFile.stale()`'s
    wall-clock timeout). A killed replica stops stepping and beating; a
    stalled one freezes for `FaultEvent.duration` ticks — a long enough
    stall is indistinguishable from death and gets fenced too.
  * Fencing a replica evicts its in-flight requests
    (`ServeEngine.evict_inflight`) back onto the router queue, oldest
    first, with their ORIGINAL enqueue times, and the replica never
    rejoins on its own (no resurrection: a fenced replica that wakes up
    again must not double-serve re-queued work). Re-queued requests
    restart from scratch on a survivor; partial tokens from the dead
    replica are discarded and counted as `wasted_toks`.
  * `FaultPlan.recover(replica, at_tick)` is the ONLY way back: a fresh
    process takes over the replica slot — any in-flight work is evicted
    back to the router (conservation), the engine rebuilds fresh state
    from the shared params, the heartbeat is cleared and re-beaten, and
    the replica rejoins least-loaded dispatch. The semantics are uniform
    (kill-then-recover, fence-then-recover, or a rolling restart of a
    healthy replica all behave identically) and idempotent across
    repeated `flap()` cycles.
  * A `StepWatchdog` per replica (EWMA straggler detector) observes real
    step wall-times; its events are reported in the stats but never
    steer scheduling, so they cannot break determinism.

The router is host-side: `FaultPlan().flap(1, at_tick=8, down_ticks=4)`
makes a kill→recover cycle a deterministic event, no process murder
required. Its replicas run on `device` (the card unless device='cpu');
tests/test_torch_router.py holds it to the JAX package's Router.
"""

from __future__ import annotations

import dataclasses
import heapq
import tempfile
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.fault import HeartbeatFile, StepWatchdog, backoff_ticks
from repro_torch.serve.engine import (Request, RequestStats, ServeEngine,
                                      _to_device, percentile, request_tpot_s)
from repro_torch.serve.trace import Trace

_NO_DEADLINE = 1 << 62


# --------------------------------------------------------------- fault plan

@dataclasses.dataclass
class FaultEvent:
    """One scripted fault: at `tick`, `replica` is killed (permanently
    stops stepping and beating), stalled (frozen for `duration` ticks,
    then resumes — unless the router fenced it first), or recovered (a
    fresh process takes over the replica slot and rejoins dispatch).
    `seq` is the insertion index FaultPlan assigns — same-tick events
    apply in insertion order, so kill+recover on one tick is legal and
    deterministic."""
    tick: int
    replica: int
    kind: str                 # "kill" | "stall" | "recover"
    duration: int = 0         # stall length in ticks (kind == "stall")
    seq: int = -1             # insertion index (assigned by FaultPlan)


class FaultPlan:
    """A deterministic fault-injection script for Router.run.

    Example::

        from repro_torch.serve.router import FaultPlan
        plan = FaultPlan().kill(1, at_tick=8).recover(1, at_tick=12)
        plan.flap(0, at_tick=20, down_ticks=3, times=2)
        assert [e.kind for e in plan.events_at(8)] == ["kill"]
    """

    def __init__(self, events: Optional[List[FaultEvent]] = None):
        self.events: List[FaultEvent] = []
        self._seq = 0
        for e in (events or []):
            self._add(e)

    def _add(self, ev: FaultEvent) -> "FaultPlan":
        ev.seq = self._seq
        self._seq += 1
        self.events.append(ev)
        return self

    def kill(self, replica: int, *, at_tick: int) -> "FaultPlan":
        return self._add(FaultEvent(tick=at_tick, replica=replica,
                                    kind="kill"))

    def stall(self, replica: int, *, at_tick: int, ticks: int
              ) -> "FaultPlan":
        return self._add(FaultEvent(tick=at_tick, replica=replica,
                                    kind="stall", duration=ticks))

    def recover(self, replica: int, *, at_tick: int) -> "FaultPlan":
        """Schedule a fresh process to take over `replica` at `at_tick`:
        in-flight work is evicted back to the router, engine state is
        rebuilt from the shared params, and the replica rejoins
        dispatch."""
        return self._add(FaultEvent(tick=at_tick, replica=replica,
                                    kind="recover"))

    def flap(self, replica: int, *, at_tick: int, down_ticks: int,
             times: int = 1, period: Optional[int] = None) -> "FaultPlan":
        """`times` kill→recover cycles: kill at `at_tick + k*period`,
        recover `down_ticks` later (period defaults to 2*down_ticks).
        The crash-loop scenario — fencing and recovery must both be
        idempotent across cycles."""
        if down_ticks < 1:
            raise ValueError(f"down_ticks must be >= 1, got {down_ticks}")
        if times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        p = 2 * down_ticks if period is None else period
        if times > 1 and p <= down_ticks:
            raise ValueError(f"period {p} must exceed down_ticks "
                             f"{down_ticks} for repeated flaps")
        for k in range(times):
            t0 = at_tick + k * p
            self.kill(replica, at_tick=t0)
            self.recover(replica, at_tick=t0 + down_ticks)
        return self

    def events_at(self, tick: int) -> List[FaultEvent]:
        """Same-tick events in INSERTION order (stable sort by the
        insertion index). With kill+recover legal on the same tick, which
        one wins must be a property of the plan the test author wrote —
        never a dict/list ordering accident."""
        return sorted((e for e in self.events if e.tick == tick),
                      key=lambda e: e.seq)

    def has_recovery_after(self, tick: int) -> bool:
        """Whether any replica is scheduled to recover strictly after
        `tick` — the all-replicas-dead check must keep ticking toward a
        scripted recovery instead of raising."""
        return any(e.kind == "recover" and e.tick > tick
                   for e in self.events)


# --------------------------------------------------------- overload control

@dataclasses.dataclass
class OverloadConfig:
    """Windowed overload controller knobs for the Router: brown-out
    admissions under sustained pressure, restore when the queue drains.

    Triggers (evaluated once per tick, on tick-denominated state only, so
    the controller is seed-deterministic):

      * queue_high  — brown-out when the end-of-tick queue depth exceeds
                      this for `window_ticks` CONSECUTIVE ticks (None
                      disables the depth trigger);
      * ttft_p99_high — brown-out when the p99 of admission TTFTs (ticks
                      from arrival to slot admission) observed within the
                      trailing window exceeds this (None disables).

    While browned out, every admission attempt (new arrivals and retry
    re-entries — NOT fence-evicted re-queues) is shed through the retry
    path. The brown-out lifts when the router queue drains to
    `queue_low`.

    Example::

        from repro_torch.serve.router import OverloadConfig
        ov = OverloadConfig(window_ticks=6, queue_high=8, queue_low=2)
        assert ov.window_ticks == 6
    """
    window_ticks: int = 8
    queue_high: Optional[int] = None
    ttft_p99_high: Optional[float] = None
    queue_low: int = 0


# ------------------------------------------------------------- SLO summary

def router_slo_summary(ttft_ticks: List[int], tpot_ticks: List[float],
                       ttft_s: List[float], tpot_s: List[float],
                       queue_depth_samples: List[int]) -> Dict[str, Any]:
    """Fold raw per-request latency samples + per-tick queue depths into
    the router's SLO stats (tails via the shared linear-interpolation
    `percentile`; empty samples — e.g. a run where every request was shed
    and nothing completed — degrade to 0.0).

    The `_ticks` metrics are deterministic (virtual-clock) and gateable;
    the `_s` metrics are wall clock and informational."""
    return {
        "p50_ttft_ticks": percentile(ttft_ticks, 50),
        "p99_ttft_ticks": percentile(ttft_ticks, 99),
        "p50_tpot_ticks": percentile(tpot_ticks, 50),
        "p99_tpot_ticks": percentile(tpot_ticks, 99),
        "p50_ttft_s": percentile(ttft_s, 50),
        "p99_ttft_s": percentile(ttft_s, 99),
        "p50_tpot_s": percentile(tpot_s, 50),
        "p99_tpot_s": percentile(tpot_s, 99),
        "mean_queue_depth": (float(np.mean(queue_depth_samples))
                             if queue_depth_samples else 0.0),
        "p99_queue_depth": percentile(queue_depth_samples, 99),
        "max_queue_depth": (int(max(queue_depth_samples))
                            if queue_depth_samples else 0),
    }


# ------------------------------------------------------------------ router

# paged K/V counters folded across engine incarnations (sums vs high-water
# marks): recovery resets the engine, the replica's cache history must not
_KV_SUM = ("prefix_lookups", "prefix_hits", "prefill_tokens_saved",
           "pages_allocated", "pages_freed")
_KV_MAX = ("peak_live_pages", "n_pages")


def _fold_kv(acc: Dict[str, Any], kv: Optional[Dict[str, Any]]) -> None:
    if not kv:
        return
    for k in _KV_SUM:
        acc[k] = acc.get(k, 0) + kv.get(k, 0)
    for k in _KV_MAX:
        acc[k] = max(acc.get(k, 0), kv.get(k, 0))


# speculative-decoding counters: all plain sums across incarnations (the
# derived rates are recomputed from the folded sums at aggregation)
_SPEC_SUM = ("proposed", "accepted", "rejected", "bonus", "tokens_emitted",
             "verify_steps", "draft_steps")


def _fold_spec(acc: Dict[str, Any], sp: Optional[Dict[str, Any]]) -> None:
    if not sp:
        return
    for k in _SPEC_SUM:
        acc[k] = acc.get(k, 0) + sp.get(k, 0)


@dataclasses.dataclass
class _Replica:
    idx: int
    engine: ServeEngine
    hb: HeartbeatFile
    watchdog: StepWatchdog
    alive: bool = True            # router's view: dispatchable
    killed: bool = False          # fault plan: dead until recovered
    stall_until: int = -1         # frozen through tick stall_until - 1
    fenced_at: int = -1
    completed: int = 0
    evicted: int = 0
    stalled_ticks: int = 0
    straggler_events: int = 0
    recoveries: int = 0
    # counters folded in from incarnations retired by recover() — the
    # engine resets on recovery, the replica's history must not
    hist_decode_steps: int = 0
    hist_prefills: int = 0
    hist_kv: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hist_spec: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def healthy_at(self, tick: int) -> bool:
        """Whether the replica PROCESS runs this tick (steps + beats) —
        independent of the router's alive/fenced view of it."""
        return not self.killed and tick >= self.stall_until

    def outstanding(self) -> int:
        return self.engine.active_count + self.engine.queue_depth

    def total_decode_steps(self) -> int:
        return self.hist_decode_steps + self.engine.last_stats["decode_steps"]

    def total_prefills(self) -> int:
        return self.hist_prefills + self.engine.last_stats["prefills"]

    def total_kv(self) -> Dict[str, Any]:
        """Replica-lifetime paged-cache counters: history from retired
        incarnations plus the current engine's run ({} when paging is
        off)."""
        acc = dict(self.hist_kv)
        _fold_kv(acc, (self.engine.last_stats or {}).get("kvcache"))
        return acc

    def total_spec(self) -> Dict[str, Any]:
        """Replica-lifetime speculative-decoding counters ({} when spec
        is off)."""
        acc = dict(self.hist_spec)
        _fold_spec(acc, (self.engine.last_stats or {}).get("spec"))
        return acc


class Router:
    """Load-balance a request trace across N replica ServeEngines.

    Replicas share one params tree, moved to `device` once (the card
    unless device='cpu'); each replica owns its caches. `rng_seed` is
    shared so any replica draws the identical per-request sample stream —
    the property failover correctness rests on. `mesh=` is passed to the
    engines, which then serve tensor-parallel over it (`ServeEngine`'s
    exact-TP: every rank runs the same Router on the same trace, and
    each replica keeps its own shards of `params`).

    Overload knobs (all deterministic): `max_queue` bounds the admission
    queue (None = unbounded), `shed_policy` picks the victim on a full
    queue ("reject-newest" | "reject-oldest"), shed requests retry up to
    `retry_budget` times with exponential backoff
    (`retry_backoff_base * 2**k` ticks, capped at `retry_backoff_cap`),
    and `overload=OverloadConfig(...)` arms the brown-out controller.

    Example (tiny model, CPU)::

        import repro_torch
        from repro_torch.configs.base import get_config, reduce_config
        from repro_torch.serve.router import FaultPlan, Router
        from repro_torch.serve.trace import TraceConfig, generate_trace
        cfg = reduce_config(get_config("qwen2-1.5b"), d_model=64, vocab=128)
        params = repro_torch.build_model(cfg).init_params(0, device="cpu")
        router = Router(cfg, params, replicas=2, max_batch=2, cache_len=64,
                        device="cpu")
        trace = generate_trace(TraceConfig(n_requests=6, out_max=8,
                                           prompt_max=16))
        out, stats = router.run(trace)
        assert stats["completed"] == 6
    """

    def __init__(self, cfg: ModelConfig, params, *, replicas: int = 2,
                 max_batch: int = 4, cache_len: int = 512,
                 rng_seed: int = 0, mesh=None,
                 heartbeat_dir: Optional[str] = None,
                 stale_after_ticks: int = 3,
                 fault_plan: Optional[FaultPlan] = None,
                 max_ticks: int = 100_000,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-newest",
                 retry_budget: int = 2,
                 retry_backoff_base: int = 1,
                 retry_backoff_cap: int = 32,
                 overload: Optional[OverloadConfig] = None,
                 kv_page_size: int = 0,
                 kv_pages: Optional[int] = None,
                 kv_dtype: str = "bf16",
                 prefix_reuse: bool = True,
                 draft_cfg=None, draft_params=None, spec_k: int = 0,
                 device=backend.DEFAULT_DEVICE):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if shed_policy not in ("reject-newest", "reject-oldest"):
            raise ValueError(f"unknown shed_policy {shed_policy!r} "
                             "(expected 'reject-newest' or 'reject-oldest')")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {retry_budget}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.stale_after_ticks = stale_after_ticks
        self.fault_plan = fault_plan or FaultPlan()
        self.max_ticks = max_ticks
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.retry_budget = retry_budget
        self.retry_backoff_base = retry_backoff_base
        self.retry_backoff_cap = retry_backoff_cap
        self.overload = overload
        self.kv_page_size = kv_page_size
        self.spec_k = spec_k
        self.device = backend.resolve_device(device)
        # one copy on the device, shared (read-only) by every replica
        params = _to_device(params, self.device)
        if draft_params is not None:
            draft_params = _to_device(draft_params, self.device)
        hb_dir = heartbeat_dir or tempfile.mkdtemp(prefix="repro-router-hb-")
        self.heartbeat_dir = hb_dir
        self.replicas: List[_Replica] = []
        for i in range(replicas):
            # kv knobs pass straight through: each replica owns its OWN
            # page pool and prefix index (replica-local reuse — a shared
            # prompt prefills once per replica, not once per fleet)
            # spec knobs pass straight through too: the draft params are
            # shared (read-only) but each replica owns its draft cache,
            # and the salted key schedule makes a re-queued request's
            # draws identical on any replica
            eng = ServeEngine(cfg, params, max_batch=max_batch,
                              cache_len=cache_len, rng_seed=rng_seed,
                              mesh=mesh, kv_page_size=kv_page_size,
                              kv_pages=kv_pages, kv_dtype=kv_dtype,
                              prefix_reuse=prefix_reuse,
                              draft_cfg=draft_cfg,
                              draft_params=draft_params, spec_k=spec_k,
                              device=self.device)
            rep = _Replica(
                idx=i, engine=eng,
                hb=HeartbeatFile(hb_dir, name=f"REPLICA_{i}"),
                watchdog=StepWatchdog())
            rep.watchdog.on_straggler = (
                lambda step, dt, ewma, _r=rep: _bump_straggler(_r))
            self.replicas.append(rep)
        self.last_stats: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- pieces

    def _alive(self) -> List[_Replica]:
        return [r for r in self.replicas if r.alive]

    def _fence(self, rep: _Replica, tick: int, rq: deque,
               arrival_tick: Dict[int, int], where: Dict[int, int]
               ) -> Tuple[int, int]:
        """Declare rep dead: evict its in-flight work back onto the router
        queue (oldest arrivals first, ahead of newer work) and stop
        dispatching to it until a scripted recover event replaces it.
        Returns (n_requeued, wasted_tokens). Idempotent: fencing an
        already-fenced replica evicts nothing and changes nothing."""
        rep.alive = False
        if rep.fenced_at < 0:
            rep.fenced_at = tick
        evicted, wasted = rep.engine.evict_inflight()
        rep.evicted += len(evicted)
        for r in evicted:
            where.pop(r.rid, None)
        evicted.sort(key=lambda r: arrival_tick[r.rid])
        rq.extendleft(reversed(evicted))
        return len(evicted), wasted

    def _recover(self, rep: _Replica, tick: int, rq: deque,
                 arrival_tick: Dict[int, int], where: Dict[int, int]
                 ) -> Tuple[int, int, int, bool]:
        """A fresh process takes over the replica slot. Uniform semantics
        regardless of prior state (killed, fenced, stalled, or healthy
        rolling restart): any in-flight work is evicted back to the FRONT
        of the router queue (request conservation — a killed-but-not-yet-
        fenced replica's work must not vanish with it), the engine
        rebuilds fresh state from the shared params, the heartbeat is
        cleared and immediately re-beaten (so the recovered replica is
        not instantly re-fenced), and the replica rejoins least-loaded
        dispatch. Idempotent across repeated flap() cycles. Returns
        (n_requeued, wasted_tokens, fence_to_recover_ticks, was_fenced).
        """
        evicted, wasted = rep.engine.evict_inflight()
        rep.evicted += len(evicted)
        for r in evicted:
            where.pop(r.rid, None)
        evicted.sort(key=lambda r: arrival_tick[r.rid])
        rq.extendleft(reversed(evicted))
        # fold the retiring incarnation's counters into replica history
        # before reset wipes them
        st = rep.engine.finalize()
        rep.hist_decode_steps += st["decode_steps"]
        rep.hist_prefills += st["prefills"]
        _fold_kv(rep.hist_kv, st.get("kvcache"))
        _fold_spec(rep.hist_spec, st.get("spec"))
        rep.engine.reset()
        was_fenced = not rep.alive
        gap = tick - rep.fenced_at if (was_fenced and rep.fenced_at >= 0) \
            else 0
        rep.alive = True
        rep.killed = False
        rep.stall_until = -1
        rep.fenced_at = -1
        rep.recoveries += 1
        rep.hb.clear()
        rep.hb.beat(tick)
        return len(evicted), wasted, gap, was_fenced

    # ---------------------------------------------------------------- run

    def run(self, trace: Trace, *, tick_s: float = 0.05
            ) -> Tuple[Dict[int, List[int]], Dict[str, Any]]:
        """Drive the trace until every request reaches a terminal outcome
        (completed | shed | deadline_missed). Returns
        ({rid: tokens} for COMPLETED requests, stats — including
        stats["outcomes"], the full {rid: terminal state} map).

        tick_s maps the trace's virtual arrival times onto ticks; it has
        no relation to the wall clock (a tick takes however long the
        replicas' decode steps take)."""
        n_req = len(trace.requests)
        arrivals = deque(zip(trace.arrival_ticks(tick_s),
                             trace.requests))       # ordered by t_arrival
        for rep in self.replicas:
            rep.engine.reset()
            rep.hist_decode_steps = 0
            rep.hist_prefills = 0
            rep.hist_kv = {}
            rep.hist_spec = {}
        t_wall0 = time.perf_counter()
        ov = self.overload

        rq: deque = deque()                  # router-level admission queue
        terminal: Dict[int, str] = {}        # rid -> terminal outcome
        arrival_tick: Dict[int, int] = {}
        arrival_wall: Dict[int, float] = {}
        deadline_at: Dict[int, int] = {}     # rid -> absolute deadline tick
        attempts: Dict[int, int] = {}        # rid -> shed-retry count used
        retry_heap: List[Tuple[int, int, Request]] = []  # (due, seq, req)
        retry_seq = 0
        where: Dict[int, int] = {}           # in-flight rid -> replica idx
        first_tick: Dict[int, int] = {}      # last successful admission
        finish_tick: Dict[int, int] = {}
        done_by: Dict[int, int] = {}         # rid -> replica idx
        out: Dict[int, List[int]] = {}       # completed outputs (harvested
        per_req: Dict[int, RequestStats] = {}  # at finish: engines may
        queue_samples: List[int] = []          # reset on recovery)
        toks_at_tick: List[int] = []         # tokens produced per tick
        requeued = 0
        wasted = 0
        shed_events = 0                      # admission rejections
        retries = 0                          # backoff re-entries scheduled
        max_outstanding = 0
        killed: List[int] = []
        fenced: List[int] = []
        recovered: List[int] = []
        recovery_gaps: List[int] = []        # fence -> recover, per episode
        brown = False
        brownouts = 0
        brownout_ticks = 0
        depth_win: deque = deque(maxlen=ov.window_ticks if ov else 1)
        ttft_win: deque = deque()            # (tick, admission ttft_ticks)

        def _mark(rid: int, state: str) -> None:
            assert rid not in terminal, (rid, state, terminal[rid])
            terminal[rid] = state

        def _try_admit(req: Request) -> None:
            """Admission control for new arrivals and retry re-entries
            (fence/recovery evictions bypass it — already-admitted work
            re-enters at the queue front). Deterministic: shed on
            brown-out or a full queue; a shed request with budget left
            re-enters after an exponential backoff, else it is terminally
            shed."""
            nonlocal shed_events, retries, retry_seq
            victim = None
            full = (self.max_queue is not None
                    and len(rq) >= self.max_queue)
            if brown:
                victim = req                 # brown-out: always the newest
            elif full:
                if self.shed_policy == "reject-oldest" and rq:
                    victim = rq.popleft()    # make room for the newcomer
                    rq.append(req)
                else:
                    victim = req
            if victim is None:
                rq.append(req)
                return
            shed_events += 1
            a = attempts.get(victim.rid, 0)
            if a < self.retry_budget:
                attempts[victim.rid] = a + 1
                due = tick + backoff_ticks(a + 1,
                                           base=self.retry_backoff_base,
                                           cap=self.retry_backoff_cap)
                retry_seq += 1
                heapq.heappush(retry_heap, (due, retry_seq, victim))
                retries += 1
            else:
                _mark(victim.rid, "shed")

        tick = 0
        while len(terminal) < n_req:
            if tick >= self.max_ticks:
                raise RuntimeError(
                    f"router exceeded max_ticks={self.max_ticks} with "
                    f"{n_req - len(terminal)} request(s) unfinished")

            # 1. scripted faults take effect before anything runs;
            # same-tick events apply in plan-insertion order
            for ev in self.fault_plan.events_at(tick):
                rep = self.replicas[ev.replica]
                if ev.kind == "kill":
                    rep.killed = True
                    killed.append(rep.idx)
                elif ev.kind == "stall":
                    rep.stall_until = max(rep.stall_until,
                                          tick + ev.duration)
                elif ev.kind == "recover":
                    n_rq, n_waste, gap, was_fenced = self._recover(
                        rep, tick, rq, arrival_tick, where)
                    requeued += n_rq
                    wasted += n_waste
                    recovered.append(rep.idx)
                    if was_fenced:
                        recovery_gaps.append(gap)
                else:
                    raise ValueError(f"unknown fault kind {ev.kind!r}")

            # 2. admission: due retries first (they are older work), then
            # trace arrivals whose virtual time has come — both through
            # the bounded-queue shed policy
            if brown:
                brownout_ticks += 1
            while retry_heap and retry_heap[0][0] <= tick:
                _, _, req = heapq.heappop(retry_heap)
                _try_admit(req)
            while arrivals and arrivals[0][0] <= tick:
                _, tr = arrivals.popleft()
                rid = tr.request.rid
                arrival_tick[rid] = tick
                arrival_wall[rid] = time.perf_counter()
                if tr.deadline_ticks is not None:
                    deadline_at[rid] = tick + tr.deadline_ticks
                _try_admit(tr.request)

            # 3. deadline sweep: a request that has not completed by the
            # end of its deadline tick is evicted wherever it sits — the
            # router queue, the backoff heap, or mid-flight in a replica
            # (targeted evict_inflight keeps batch-mates undisturbed)
            if deadline_at:
                keep_q: deque = deque()
                while rq:
                    r = rq.popleft()
                    if deadline_at.get(r.rid, _NO_DEADLINE) < tick:
                        _mark(r.rid, "deadline_missed")
                    else:
                        keep_q.append(r)
                rq = keep_q
                if retry_heap:
                    live = [(d, s, r) for (d, s, r) in retry_heap
                            if deadline_at.get(r.rid, _NO_DEADLINE) >= tick]
                    if len(live) != len(retry_heap):
                        for d, s, r in retry_heap:
                            if deadline_at.get(r.rid, _NO_DEADLINE) < tick:
                                _mark(r.rid, "deadline_missed")
                        retry_heap = live
                        heapq.heapify(retry_heap)
                expired_by_rep: Dict[int, set] = {}
                for rid, idx in where.items():
                    if deadline_at.get(rid, _NO_DEADLINE) < tick:
                        expired_by_rep.setdefault(idx, set()).add(rid)
                for idx in sorted(expired_by_rep):
                    evicted, w = self.replicas[idx].engine.evict_inflight(
                        rids=expired_by_rep[idx])
                    wasted += w
                    for r in evicted:
                        where.pop(r.rid, None)
                        _mark(r.rid, "deadline_missed")

            # 4. failure detection: fence replicas whose heartbeat tick
            # lags too far (killed replicas stop beating; stalls longer
            # than the threshold are indistinguishable from death)
            for rep in self._alive():
                beat = rep.hb.read()
                last = beat["step"] if beat else -1
                if tick - last > self.stale_after_ticks:
                    n_rq, n_waste = self._fence(rep, tick, rq,
                                                arrival_tick, where)
                    fenced.append(rep.idx)
                    requeued += n_rq
                    wasted += n_waste

            if not self._alive() \
                    and not self.fault_plan.has_recovery_after(tick):
                raise RuntimeError(
                    "every replica is dead/fenced with "
                    f"{n_req - len(terminal)} request(s) still to serve")

            # 5. dispatch least-loaded-first; a replica holds at most
            # max_batch requests (slots + its own queue), so at most one
            # batch of in-flight work is lost per fencing
            while rq:
                cands = [r for r in self._alive()
                         if r.outstanding() < self.max_batch]
                if not cands:
                    break
                best = min(cands, key=lambda r: (r.outstanding(), r.idx))
                req = rq.popleft()
                where[req.rid] = best.idx
                best.engine.submit(req, t_enqueue=arrival_wall[req.rid])

            # 6. step every healthy replica (one scheduler round each);
            # healthy replicas beat their heartbeat with the current tick
            toks_this_tick = 0
            for rep in self.replicas:
                if not rep.healthy_at(tick):
                    if not rep.killed:
                        rep.stalled_ticks += 1
                    continue
                t0 = time.perf_counter()
                report = rep.engine.step()
                dt = time.perf_counter() - t0
                rep.hb.beat(tick)
                if report.decoded or report.admitted:
                    rep.watchdog.observe(tick, dt)
                toks_this_tick += len(report.admitted) + report.decoded
                for rid in report.admitted:
                    first_tick[rid] = tick
                    if ov is not None:
                        ttft_win.append((tick, tick - arrival_tick[rid]))
                for rid in report.finished:
                    finish_tick[rid] = tick
                    done_by[rid] = rep.idx
                    rep.completed += 1
                    where.pop(rid, None)
                    _mark(rid, "completed")
                    # harvest now: a later recovery resets this engine
                    out[rid] = list(rep.engine.outputs[rid])
                    per_req[rid] = rep.engine.request_stats[rid]
            toks_at_tick.append(toks_this_tick)

            # 7. end-of-tick accounting + overload controller
            depth = len(rq) + sum(r.engine.queue_depth
                                  for r in self._alive())
            queue_samples.append(depth)
            max_outstanding = max(
                [max_outstanding] + [r.outstanding()
                                     for r in self.replicas])
            if ov is not None:
                depth_win.append(depth)
                while ttft_win and ttft_win[0][0] <= tick - ov.window_ticks:
                    ttft_win.popleft()
                if brown:
                    if len(rq) <= ov.queue_low:
                        brown = False
                else:
                    trig_q = (ov.queue_high is not None
                              and len(depth_win) == ov.window_ticks
                              and all(d > ov.queue_high
                                      for d in depth_win))
                    trig_t = (ov.ttft_p99_high is not None and ttft_win
                              and percentile([t for _, t in ttft_win], 99)
                              > ov.ttft_p99_high)
                    if trig_q or trig_t:
                        brown = True
                        brownouts += 1
            tick += 1

        wall = time.perf_counter() - t_wall0
        for rep in self.replicas:
            rep.engine.finalize()
        stats = self._aggregate(
            trace, n_req=n_req, ticks=tick, tick_s=tick_s, wall=wall,
            out=out, per_req=per_req, terminal=terminal,
            arrival_tick=arrival_tick, first_tick=first_tick,
            finish_tick=finish_tick, done_by=done_by,
            queue_samples=queue_samples, toks_at_tick=toks_at_tick,
            requeued=requeued, wasted=wasted, shed_events=shed_events,
            retries=retries, max_outstanding=max_outstanding,
            killed=killed, fenced=fenced, recovered=recovered,
            recovery_gaps=recovery_gaps, brownouts=brownouts,
            brownout_ticks=brownout_ticks)
        self.last_stats = stats
        return out, stats

    # ---------------------------------------------------------- aggregate

    def _aggregate(self, trace: Trace, *, n_req, ticks, tick_s, wall, out,
                   per_req, terminal, arrival_tick, first_tick,
                   finish_tick, done_by, queue_samples, toks_at_tick,
                   requeued, wasted, shed_events, retries, max_outstanding,
                   killed, fenced, recovered, recovery_gaps, brownouts,
                   brownout_ticks) -> Dict[str, Any]:
        # SLO samples come from COMPLETED requests only: a shed or
        # deadline-missed request has no end-to-end latency to report
        # (its admissions, if any, were discarded as waste)
        ttft_ticks = [first_tick[rid] - arrival_tick[rid]
                      for rid in first_tick if rid in done_by]
        tpot_ticks = [(finish_tick[rid] - first_tick[rid])
                      / (len(out[rid]) - 1)
                      for rid in first_tick
                      if rid in done_by and len(out[rid]) > 1]
        ttft_s = [st.ttft_s for st in per_req.values() if st.new_tokens > 0]
        tpot_s = [t for t in (request_tpot_s(st) for st in per_req.values())
                  if t is not None]
        goodput_toks = sum(len(v) for v in out.values())
        n_shed = sum(1 for v in terminal.values() if v == "shed")
        n_miss = sum(1 for v in terminal.values() if v == "deadline_missed")
        stats: Dict[str, Any] = {
            "replicas": len(self.replicas),
            "ticks": ticks,
            "tick_s": tick_s,
            "wall_s": wall,
            "n_requests": n_req,
            "completed": len(out),
            "shed": n_shed,
            "deadline_missed": n_miss,
            "shed_rate": n_shed / n_req if n_req else 0.0,
            "deadline_miss_rate": n_miss / n_req if n_req else 0.0,
            "shed_events": shed_events,
            "retries": retries,
            "retries_per_request": retries / n_req if n_req else 0.0,
            "requeued": requeued,
            "killed": killed,
            "fenced": fenced,
            "recovered": recovered,
            "recoveries": len(recovered),
            "recovery_ticks": list(recovery_gaps),
            "mean_recovery_ticks": (float(np.mean(recovery_gaps))
                                    if recovery_gaps else 0.0),
            "brownouts": brownouts,
            "brownout_ticks": brownout_ticks,
            "outcomes": dict(terminal),
            "decode_steps": sum(r.total_decode_steps()
                                for r in self.replicas),
            "prefills": sum(r.total_prefills() for r in self.replicas),
            "goodput_toks": goodput_toks,
            "wasted_toks": wasted,
            "goodput_tok_per_s": goodput_toks / max(wall, 1e-9),
            "max_outstanding": max_outstanding,
            "straggler_events": sum(r.straggler_events
                                    for r in self.replicas),
        }
        stats.update(router_slo_summary(ttft_ticks, tpot_ticks, ttft_s,
                                        tpot_s, queue_samples))
        if self.kv_page_size:
            # fleet view of the paged caches: hit rate over all replica-
            # local indexes, page high-water occupancy, prefill work saved
            acc: Dict[str, Any] = {}
            for r in self.replicas:
                _fold_kv(acc, r.total_kv() or None)
            lookups = acc.get("prefix_lookups", 0)
            stats["kvcache"] = {
                **acc,
                "prefix_hit_rate": (acc.get("prefix_hits", 0) / lookups
                                    if lookups else 0.0),
                "pages_live": (acc.get("pages_allocated", 0)
                               - acc.get("pages_freed", 0)),
                "page_occupancy": (acc.get("peak_live_pages", 0)
                                   / acc.get("n_pages", 1)
                                   if acc.get("n_pages") else 0.0),
            }
        if self.spec_k:
            # fleet view of speculative decoding: rates recomputed from
            # the folded sums (never averaged across replicas)
            sacc: Dict[str, Any] = {}
            for r in self.replicas:
                _fold_spec(sacc, r.total_spec() or None)
            proposed = sacc.get("proposed", 0)
            vsteps = sacc.get("verify_steps", 0)
            stats["spec"] = {
                **sacc,
                "k": self.spec_k,
                "acceptance_rate": (sacc.get("accepted", 0) / proposed
                                    if proposed else 0.0),
                "accepted_tokens_per_step": (
                    sacc.get("tokens_emitted", 0) / vsteps
                    if vsteps else 0.0),
            }
        bt = trace.burst_ticks(tick_s, ticks)
        if bt:
            burst_toks = sum(toks_at_tick[k] for k in bt
                             if k < len(toks_at_tick))
            stats["burst"] = {
                "ticks": len(bt),
                "arrivals": sum(1 for rid, t in arrival_tick.items()
                                if t in bt),
                "new_tokens": burst_toks,
                "tok_per_tick": burst_toks / len(bt),
            }
        stats["per_replica"] = [
            {"replica": r.idx,
             "decode_steps": r.total_decode_steps(),
             "prefills": r.total_prefills(),
             "completed": r.completed,
             "evicted": r.evicted,
             "stalled_ticks": r.stalled_ticks,
             "straggler_events": r.straggler_events,
             "recoveries": r.recoveries,
             "killed": r.killed,
             "fenced": not r.alive}
            for r in self.replicas]
        if self.kv_page_size:
            for row, r in zip(stats["per_replica"], self.replicas):
                kv = r.total_kv()
                lk = kv.get("prefix_lookups", 0)
                row["prefix_hits"] = kv.get("prefix_hits", 0)
                row["prefix_hit_rate"] = (row["prefix_hits"] / lk
                                          if lk else 0.0)
                row["peak_live_pages"] = kv.get("peak_live_pages", 0)
        if self.spec_k:
            for row, r in zip(stats["per_replica"], self.replicas):
                sp = r.total_spec()
                prop = sp.get("proposed", 0)
                row["spec_accepted"] = sp.get("accepted", 0)
                row["spec_acceptance_rate"] = (row["spec_accepted"] / prop
                                               if prop else 0.0)
        return stats


def _bump_straggler(rep: _Replica) -> None:
    rep.straggler_events += 1
