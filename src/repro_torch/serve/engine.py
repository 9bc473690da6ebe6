"""Slot-level continuous-batching serving engine — the port of
`repro.serve.engine` (:71-208 and `ServeEngine` without the mesh, paged
cache and speculative-decoding parts).

The engine owns a fixed pool of `max_batch` slots over ONE decode batch.
Requests wait in a FIFO admission queue; whenever a slot's request
finishes, the slot is refilled from the queue by prefilling the new
request into that slot's cache lines (Model.prefill_into_slot), so new
requests join the mid-flight batch without disturbing their batch-mates.
The scheduling (which request is admitted when, which rows decode, the
StepReports and the stats counters) is host logic and is the JAX
engine's exactly.

The cache lives on `device` (the card unless device='cpu') and the model
steps update its leaves in place; "pos" is a (B,) vector so every slot
decodes at its own offset. Finished slots are masked: their pos is held,
so their rows stop growing. Dense prompts are right-padded to a shape
bucket; hybrid prompts are prefilled at their exact length (a pad would
enter the recurrent state). Admission holds every family to prompt +
max_new_tokens <= cache_len, as the JAX engine does, though the hybrid
cache keeps only the attention window.

Sampling: greedy rows (temperature 0) take the argmax of the f32 logits,
exactly. A temperature row draws with a `torch.Generator` seeded from
(rng_seed, rid, n_gen) by Gumbel-max on the CPU — deterministic per
request and independent of slot placement, batch-mates and admission
order, but NOT the JAX engine's threefry stream (`fold_in`, engine.py
:405-407): temperature > 0 is held to determinism only until threefry is
ported (ROADMAP).

`mesh=`, `kv_page_size>0` and `spec_k>0` raise ValueError naming their
ROADMAP item; `evict_inflight` and the router come later.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model

# right-padding shape buckets for slot prefill (the JAX engine compiles one
# prefill per bucket; here they keep the flash kernel's S % 256 == 0 rule
# reachable and the prefill shapes the same as the reference's)
PREFILL_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


@dataclasses.dataclass
class Request:
    """One serving request: a token prompt plus generation knobs.

    rid must be unique per engine run — it keys the output dict and the
    per-request sample stream. temperature 0.0 means greedy argmax.

    Example::

        import numpy as np, repro_torch
        r = repro_torch.Request(rid=0, prompt=np.array([3, 1, 4]),
                                max_new_tokens=8, temperature=0.7)
    """
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0


@dataclasses.dataclass
class RequestStats:
    """Per-request latency/throughput, wall-clock measured by the engine."""
    rid: int
    prompt_len: int
    new_tokens: int
    queue_wait_s: float           # enqueue -> admitted into a slot
    ttft_s: float                 # enqueue -> first token sampled
    decode_steps: int             # batched decode steps this request rode
    total_s: float                # enqueue -> finished
    tok_per_s: float              # new_tokens / (finish - admit)


@dataclasses.dataclass
class _Slot:
    rid: int
    temperature: float
    remaining: int                # new tokens still to generate
    n_gen: int                    # tokens generated so far (sample index)
    prompt_len: int
    t_enqueue: float
    t_admit: float
    t_first: float
    decode_steps: int = 0


@dataclasses.dataclass
class StepReport:
    """What one ServeEngine.step() round did.

    admitted:    rids prefilled into a slot this round (their first token
                 was sampled during admission)
    finished:    rids whose last token was produced this round (including
                 degenerate max_new_tokens<1 requests)
    decoded:     occupied rows in this round's batched decode step (0 when
                 the decode was skipped because nothing was occupied)
    queue_depth: requests still waiting after this round's admissions
    """
    admitted: List[int]
    finished: List[int]
    decoded: int
    queue_depth: int


def percentile(xs, q: float) -> float:
    """Percentile with numpy's default linear interpolation, 0.0 on an
    empty sample."""
    if len(xs) == 0:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


def request_tpot_s(st: RequestStats) -> Optional[float]:
    """Time-per-output-token of one finished request, (total_s - ttft_s) /
    (new_tokens - 1); None for requests with fewer than two tokens."""
    if st.new_tokens < 2:
        return None
    return (st.total_s - st.ttft_s) / (st.new_tokens - 1)


def aggregate_engine_stats(per_req: Dict[int, RequestStats], *,
                           n_requests: int, n_steps: int, n_prefills: int,
                           slot_steps_active: int, max_batch: int,
                           wall_s: float) -> Dict[str, Any]:
    """Fold per-request stats + scheduler counters into the engine dict
    (the JAX engine's `last_stats` schema and definitions)."""
    total_new = sum(st.new_tokens for st in per_req.values())
    ttfts = [st.ttft_s for st in per_req.values() if st.new_tokens > 0]
    tpots = [t for t in (request_tpot_s(st) for st in per_req.values())
             if t is not None]
    return {
        "p50_ttft_s": percentile(ttfts, 50),
        "p99_ttft_s": percentile(ttfts, 99),
        "p50_tpot_s": percentile(tpots, 50),
        "p99_tpot_s": percentile(tpots, 99),
        "requests": n_requests,
        "decode_steps": n_steps,
        "prefills": n_prefills,
        "new_tokens": total_new,
        "occupancy": (slot_steps_active / (n_steps * max_batch)
                      if n_steps else 1.0),
        "wall_s": wall_s,
        "tok_per_s": total_new / max(wall_s, 1e-9),
        "mean_queue_wait_s": (float(np.mean([s.queue_wait_s
                                             for s in per_req.values()]))
                              if per_req else 0.0),
        "mean_ttft_s": (float(np.mean([s.ttft_s
                                       for s in per_req.values()]))
                        if per_req else 0.0),
    }


def sample_seed(rng_seed: int, rid: int, n_gen: int) -> int:
    """The generator seed of token n_gen of request rid."""
    state = np.random.SeedSequence([rng_seed, rid, n_gen]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


class ServeEngine:
    """Slot-level continuous-batching LM server. See the module docstring
    for the scheduling model.

    Example (tiny model, CPU)::

        import numpy as np, repro_torch
        from repro_torch.configs.base import get_config, reduce_config
        cfg = reduce_config(get_config("qwen2-1.5b"), d_model=64, vocab=128)
        params = repro_torch.build_model(cfg).init_params(0, device="cpu")
        eng = repro_torch.ServeEngine(cfg, params, max_batch=2,
                                      cache_len=64, device="cpu")
        out = eng.run([repro_torch.Request(rid=0, prompt=np.arange(5),
                                           max_new_tokens=8)])
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 cache_len: int = 512, rng_seed: int = 0,
                 device=backend.DEFAULT_DEVICE, mesh=None,
                 kv_page_size: int = 0, spec_k: int = 0):
        if mesh is not None:
            raise ValueError("mesh= (tensor-parallel serving) is not ported "
                             "yet: ROADMAP queue 1, item 9 (distribution)")
        if kv_page_size:
            raise ValueError("kv_page_size>0 (the paged K/V cache) is not "
                             "ported yet: ROADMAP queue 1, item 6 (serving)")
        if spec_k:
            raise ValueError("spec_k>0 (speculative decoding) is not ported "
                             "yet: ROADMAP queue 1, item 6 (serving)")
        self.cfg = cfg
        self.device = backend.resolve_device(device)
        self.model: Model = build_model(cfg)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.rng_seed = rng_seed
        self.params = _to_device(params, self.device)
        self.last_stats: Optional[Dict[str, Any]] = None
        self._cache = None
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * max_batch

    # ------------------------------------------------------------- sampling

    def _sample_rows(self, logits: torch.Tensor,
                     slots: List[Optional[_Slot]]) -> np.ndarray:
        """Next token per row: argmax for greedy rows (and free rows), a
        Gumbel-max draw at the row's temperature for the others."""
        lg = logits.float().reshape(logits.shape[0], -1)
        toks = lg.argmax(dim=-1).cpu().numpy().astype(np.int32)
        for i, s in enumerate(slots):
            if s is None or s.temperature <= 0:
                continue
            gen = torch.Generator().manual_seed(
                sample_seed(self.rng_seed, s.rid, s.n_gen))
            u = torch.rand(lg.shape[1], generator=gen, dtype=torch.float64)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-300)))
            z = lg[i].cpu().double() / max(s.temperature, 1e-6) + gumbel
            toks[i] = int(z.argmax())
        return toks

    # ------------------------------------------------------------ admission

    def _bucket_len(self, n: int, room: int) -> int:
        # exact-length families: recurrent state (ssm/hybrid) folds every
        # token in, and MoE capacity dispatch is token-count sensitive, so
        # a right pad would change the result. Pure-attention stacks are
        # causal, so right pads are invisible to real tokens: the smallest
        # bucket that holds n and fits the cache (`room`)
        if self.cfg.family in ("ssm", "hybrid", "moe"):
            return n
        for b in PREFILL_BUCKETS:
            if n <= b <= room:
                return b
        return n

    def _fresh_cache(self):
        cache = self.model.init_cache(self.max_batch, self.cache_len,
                                      device=self.device)
        # per-row positions: each slot decodes at its own offset
        cache["pos"] = torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=self.device)
        return cache

    def _admit(self, cache, slot_idx: int, r: Request, t_enqueue: float):
        """Prefill r into slot_idx's cache lines; returns
        (cache, slot state, first sampled token)."""
        plen = len(r.prompt)
        if plen + r.max_new_tokens > self.cache_len:
            raise ValueError(f"request {r.rid}: prompt {plen} + max_new "
                             f"{r.max_new_tokens} exceeds cache_len "
                             f"{self.cache_len}")
        t_admit = time.perf_counter()
        padded = self._bucket_len(plen, self.cache_len)
        toks = np.zeros((1, padded), np.int64)
        toks[0, :plen] = r.prompt            # right pad: masked by pos
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self.model.prefill_into_slot(
            self.params, cache, slot_idx, batch, plen)
        slot = _Slot(rid=r.rid, temperature=r.temperature,
                     remaining=r.max_new_tokens, n_gen=0, prompt_len=plen,
                     t_enqueue=t_enqueue, t_admit=t_admit, t_first=0.0)
        first = int(self._sample_rows(logits, [slot])[0])
        slot.t_first = time.perf_counter()
        slot.n_gen = 1
        slot.remaining -= 1
        return cache, slot, first

    # ------------------------------------------------------------ scheduler

    def reset(self) -> None:
        """Arm a fresh scheduling run: empty queue/slots, a fresh cache,
        zeroed counters. run() calls it; a stepwise driver calls it once
        before its first submit()."""
        self._queue = deque()
        self._t_enq: Dict[int, float] = {}
        self._out: Dict[int, List[int]] = {}
        self._per_req: Dict[int, RequestStats] = {}
        self._slots = [None] * self.max_batch
        self._cache = self._fresh_cache()
        self._cur = np.zeros((self.max_batch, 1), np.int64)
        self._n_steps = 0
        self._n_prefills = 0
        self._n_submitted = 0
        self._slot_steps_active = 0
        self._t_start = time.perf_counter()

    @property
    def idle(self) -> bool:
        """True when nothing is queued and every slot is free."""
        return not self._queue and all(s is None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        """Requests admitted by submit() but not yet occupying a slot."""
        return len(self._queue)

    @property
    def active_count(self) -> int:
        """Slots currently decoding a request."""
        return sum(1 for s in self._slots if s is not None)

    @property
    def outputs(self) -> Dict[int, List[int]]:
        """Tokens generated so far this run, {rid: [tok, ...]}."""
        return self._out

    @property
    def request_stats(self) -> Dict[int, RequestStats]:
        """Per-request records of requests FINISHED so far this run."""
        return self._per_req

    def submit(self, r: Request, *, t_enqueue: Optional[float] = None
               ) -> None:
        """Enqueue one request (FIFO). t_enqueue backdates the queue-wait/
        TTFT clock."""
        if self._cache is None:
            self.reset()
        self._queue.append(r)
        self._t_enq[r.rid] = (time.perf_counter() if t_enqueue is None
                              else t_enqueue)
        self._out[r.rid] = []
        self._n_submitted += 1

    def _finish(self, i: int) -> int:
        s = self._slots[i]
        now = time.perf_counter()
        self._per_req[s.rid] = RequestStats(
            rid=s.rid, prompt_len=s.prompt_len, new_tokens=s.n_gen,
            queue_wait_s=s.t_admit - s.t_enqueue,
            ttft_s=s.t_first - s.t_enqueue,
            decode_steps=s.decode_steps, total_s=now - s.t_enqueue,
            tok_per_s=s.n_gen / max(now - s.t_admit, 1e-9))
        self._slots[i] = None
        return s.rid

    @backend.f32_accumulation()
    def step(self) -> StepReport:
        """One scheduler round: refill every free slot from the queue
        (each free slot index gets at most one admission attempt per
        round), then run one batched decode step over the occupied slots.
        With nothing occupied after admission the decode is skipped
        (decoded=0)."""
        admitted: List[int] = []
        finished: List[int] = []
        for i in range(self.max_batch):
            if self._slots[i] is None and self._queue:
                r = self._queue.popleft()
                if r.max_new_tokens < 1:     # nothing to generate
                    self._per_req[r.rid] = RequestStats(
                        rid=r.rid, prompt_len=len(r.prompt),
                        new_tokens=0, queue_wait_s=0.0, ttft_s=0.0,
                        decode_steps=0, total_s=0.0, tok_per_s=0.0)
                    finished.append(r.rid)
                    continue
                self._cache, slot, first = self._admit(
                    self._cache, i, r, self._t_enq[r.rid])
                self._n_prefills += 1
                self._out[r.rid].append(first)
                self._cur[i, 0] = first
                self._slots[i] = slot
                admitted.append(r.rid)
                if slot.remaining <= 0:      # max_new_tokens == 1
                    finished.append(self._finish(i))
        if not any(s is not None for s in self._slots):
            return StepReport(admitted=admitted, finished=finished,
                              decoded=0, queue_depth=len(self._queue))
        active = np.array([s is not None for s in self._slots])
        old_pos = self._cache["pos"]
        logits, new = self.model.decode_step(
            self.params, self._cache,
            torch.from_numpy(self._cur.copy()).to(self.device))
        # done-row masking: hold finished slots' pos so their rows stop
        # growing (the step wrote one masked, invisible line there)
        new["pos"] = torch.where(torch.from_numpy(active).to(self.device),
                                 new["pos"], old_pos)
        self._cache = new
        self._n_steps += 1
        self._slot_steps_active += int(active.sum())
        toks = self._sample_rows(logits, self._slots)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            tok = int(toks[i])
            self._out[s.rid].append(tok)
            self._cur[i, 0] = tok
            s.n_gen += 1
            s.remaining -= 1
            s.decode_steps += 1
            if s.remaining <= 0:
                finished.append(self._finish(i))
        return StepReport(admitted=admitted, finished=finished,
                          decoded=int(active.sum()),
                          queue_depth=len(self._queue))

    def finalize(self) -> Dict[str, Any]:
        """Aggregate this run's counters into the engine-stats dict (also
        stored on last_stats)."""
        wall = time.perf_counter() - self._t_start
        engine_stats = aggregate_engine_stats(
            self._per_req, n_requests=self._n_submitted,
            n_steps=self._n_steps, n_prefills=self._n_prefills,
            slot_steps_active=self._slot_steps_active,
            max_batch=self.max_batch, wall_s=wall)
        self.last_stats = engine_stats
        return engine_stats

    def run(self, requests: List[Request], *, collect_stats: bool = False):
        """Serve requests with slot-level continuous batching. Returns
        {rid: generated tokens}, or (that, stats) with collect_stats=True,
        stats = {"requests": {rid: RequestStats}, "engine": {...}}."""
        self.reset()
        for r in requests:
            self.submit(r, t_enqueue=self._t_start)
        while not self.idle:
            self.step()
        out = self._out
        engine_stats = self.finalize()
        if collect_stats:
            return out, {"requests": self._per_req, "engine": engine_stats}
        return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
