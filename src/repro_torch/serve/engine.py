"""Slot-level continuous-batching serving engine — the port of
`repro.serve.engine` (:71-208 and `ServeEngine` with its paged K/V cache,
speculative decoding, `evict_inflight` and tensor-parallel serving).

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
max_new_tokens (+ spec_k) <= cache_len, as the JAX engine does, though
the hybrid cache keeps only the attention window; a vlm prompt counts its
n_vis_tokens patch lines, which also come off the room its text bucket
may take. A request's `extra` (whisper's "frames", internvl2's "vis")
joins the batch of its admission.

Sampling is the JAX engine's stream: greedy rows (temperature 0) take the
argmax of the f32 logits; token n_gen of request rid at temperature T is
`categorical(fold_in(fold_in(prng_key(rng_seed), rid), n_gen), logits /
max(T, 1e-6))`, Threefry drawn on the engine's device (serve/rng.py), so
identical requests draw identical tokens whatever their slot, batch-mates
or admission order, and whichever replica serves them.

Paged K/V cache (`kv_page_size > 0`, serve/kvcache.py): admission opens
the request's block table; on a prefix hit the cached pages are copied
into the slot's rows and only the suffix is prefilled
(`Model.prefill_continue`: chunked attention over the row, no flash);
then the prompt's full pages are published to the prefix index. Decode
grows the block table a page at a time and a finished or evicted request
releases it once; `last_stats["kvcache"]` holds the cache's stats.
Decode still reads the dense slot cache, as in the JAX engine: the paged
decode kernels are reached through the registry only. Families whose
cache is not paged K/V (hybrid) serve unpaged. `kv_dtype="int8"`
quantizes the published pages.

Speculative decoding (`spec_k > 0` with `draft_cfg=`/`draft_params=`,
serve/spec.py): each round the dense draft proposes spec_k candidates per
active slot, one `Model.decode_verify` forward of the target scores them
all, the host accepts, and both caches roll back to the last accepted
line; `last_stats["spec"]` holds the counters. The draft keeps its own
slot cache on the device (never page-accounted). As in the JAX engine,
the verify reads the dense slot cache, not the paged kernels.

The stepwise surface (`reset`, `submit`, `step`, `evict_inflight`,
`finalize`) is what the multi-replica router (serve/router.py) drives.

Tensor-parallel serving (`mesh=`, a launch.mesh.Mesh with a "model"
axis; every family): explicit SPMD, one engine a rank, every
rank given the same whole params and the same requests. The engine lays
its state out by `dist.sharding.serve_specs` (exact-TP: weights split on
their output dims only, the slot cache head-wise where the mesh divides
the kv heads, the hybrid conv/h and rwkv wkv states on their channels or
heads, scheduler state replicated), keeps only this rank's shards
(`local_shard`, copied, so the caller may free the whole tree; a leaf
that packs tensors side by side, mamba's in_proj, keeps its block of
each: `sharding.PackedSpec`) and runs
every model call under `layers.exact_tp_scope` with a
`DistCtx(mesh, model_axis="model")`. The row-parallel
products gather their activation first, so every rank computes the same
whole logits in the one-device order and samples the same tokens: the
scheduler runs the same on every rank, and the outputs are bit-equal to
the mesh-less engine's where the column-shard products are bit-equal to
the whole product's columns (tests/test_torch_serve_tp.py on the CPU).
An engine without a mesh runs its rounds in the same scope with no
mesh, in the sharded engine's contraction order (layers.py), so it is
the reference a sharded engine is held to.
`device_stats()` gathers each rank's shard bytes; `last_stats` gains
"devices" and "per_device". Paged and spec engines refuse a mesh, as in
the JAX engine.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.models import layers
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.registry import Model, build_model
from repro_torch.serve import rng
from repro_torch.serve import spec as spec_lib
from repro_torch.serve.kvcache import PagedKVCache

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
    # extra single-row model inputs, e.g. {"vis": (1, n_vis, D)} for vlm or
    # {"frames": (1, enc_seq, D)} for encdec (numpy arrays or tensors; the
    # engine moves them to its device in their own dtype)
    extra: Optional[Dict[str, Any]] = None


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
                 kv_page_size: int = 0, kv_pages: Optional[int] = None,
                 kv_dtype: str = "bf16", prefix_reuse: bool = True,
                 draft_cfg: Optional[ModelConfig] = None, draft_params=None,
                 spec_k: int = 0):
        if mesh is not None:
            if kv_page_size:
                raise ValueError("paged K/V cache (kv_page_size>0) does not "
                                 "compose with mesh= tensor parallelism")
            if spec_k:
                raise ValueError("speculative decoding (spec_k>0) does not "
                                 "compose with mesh= tensor parallelism")
            if "model" not in getattr(mesh, "shape", {}):
                raise ValueError("mesh= takes a launch.mesh.Mesh with a "
                                 f"'model' axis, not {mesh!r}")
        self.cfg = cfg
        self.device = backend.resolve_device(device)
        self.model: Model = build_model(cfg)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.mesh = mesh
        self._specs = None
        self._ctx = None
        # the model calls' ctx= (only a sharded engine passes one)
        self._ctx_kw: Dict[str, Any] = {}
        # this rank's column-split weights, for exact_tp_scope
        self._columns: Dict[int, Any] = {}
        self._cache_bytes_local = 0
        if mesh is None:
            self.params = _to_device(params, self.device)
        else:
            self._specs = sharding.serve_specs(cfg, mesh, max_batch=max_batch,
                                               cache_len=cache_len,
                                               model=self.model)
            # this rank's shards, copied off the whole tree; replicated
            # leaves are the caller's tensors
            self.params = _local_params(params, self._specs.params,
                                        self.model.abstract_params(), mesh,
                                        self.device)
            self._columns = sharding.column_blocks(
                self.params, self._specs.params, mesh)
            # the ctx rides along every model call (decode cache layout,
            # the flash kernel's local problem)
            self._ctx = layers.DistCtx(mesh=mesh, model_axis="model")
            self._ctx_kw = {"ctx": self._ctx}
            # one rank's cache bytes, from the local shapes (the same on
            # every rank) and the (B,) int32 pos
            ab = self.model.init_cache(max_batch, cache_len, abstract=True)
            self._cache_bytes_local = 4 * max_batch + sum(
                math.prod(sharding.local_shape(t.shape, self._specs.cache[k],
                                               mesh)) * t.element_size()
                for k, t in ab.items() if k != "pos")
        self.kv_page_size = kv_page_size
        self.kv_pages = kv_pages
        self.kv_dtype = kv_dtype
        self.prefix_reuse = prefix_reuse
        self._kv: Optional[PagedKVCache] = None
        # speculative decoding: the accept loop and the per-row position
        # rollback are host-managed, like the page pool
        self.spec_k = spec_k
        self.draft_model: Optional[Model] = None
        self.draft_params = None
        self._draft_cache = None
        self._spec_inflight: Dict[int, int] = {}
        self._spec: Optional[Dict[str, int]] = None
        if spec_k:
            if draft_cfg is None or draft_params is None:
                raise ValueError("spec_k>0 requires draft_cfg= and "
                                 "draft_params=")
            if draft_cfg.family != "dense":
                raise ValueError("draft model must be a dense decoder "
                                 f"(per-row K/V rollback): {draft_cfg.family!r}")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft/target vocab mismatch: "
                    f"{draft_cfg.vocab_size} vs {cfg.vocab_size}")
            if self.model.decode_verify is None:
                raise ValueError(
                    "target family has no multi-position decode_verify "
                    f"entry (spec_k>0 needs one): {cfg.family!r}; as in "
                    "the JAX package, only the dense family has one "
                    "(ROADMAP queue 1, item 8.1)")
            self.draft_model = build_model(draft_cfg)
            self.draft_params = _to_device(draft_params, self.device)
        # never split: per-request keys are fold_in derivations of this
        # base, so no shared RNG state advances across requests
        self.rng = rng.prng_key(rng_seed, device=self.device)
        self.last_stats: Optional[Dict[str, Any]] = None
        self._cache = None
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * max_batch

    # ------------------------------------------------------------- sampling

    def _draw(self, logits: torch.Tensor, slots: List[Optional[_Slot]],
              n_gens: np.ndarray, salt: Optional[int] = None) -> np.ndarray:
        """Next token per row: argmax for greedy (and free) rows; a row at
        temperature T draws categorical(key, logits / max(T, 1e-6)) with
        key = fold_in(fold_in(base, rid), n_gen), folded once more with
        `salt` for a spec-round draft draw (the JAX engine's
        `_sample_batch_impl` and `_spec_sample_impl`)."""
        lg = logits.float().reshape(logits.shape[0], -1)
        toks = lg.argmax(dim=-1)
        hot = [i for i, s in enumerate(slots) if s is not None
               and s.temperature > 0]
        if hot:
            idx = torch.tensor(hot, device=self.device)
            rids = torch.tensor([slots[i].rid for i in hot],
                                device=self.device)
            ngen = torch.tensor([int(n_gens[i]) for i in hot],
                                device=self.device)
            temps = torch.tensor([slots[i].temperature for i in hot],
                                 dtype=torch.float32, device=self.device)
            keys = rng.fold_in(rng.fold_in(self.rng.expand(len(hot), 2),
                                           rids), ngen)
            if salt is not None:
                keys = rng.fold_in(keys, salt)
            rows = lg.index_select(0, idx)
            toks[idx] = rng.categorical(
                keys, rows / torch.clamp_min(temps, 1e-6)[:, None])
        return toks.cpu().numpy()

    def _sample_rows(self, logits: torch.Tensor,
                     slots: List[Optional[_Slot]]) -> np.ndarray:
        return self._draw(logits, slots,
                          np.array([s.n_gen if s else 0 for s in slots]))

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
        if self._specs is None:
            cache = self.model.init_cache(self.max_batch, self.cache_len,
                                          device=self.device)
        else:
            # this rank's block of every leaf, allocated at its local shape
            ab = self.model.init_cache(self.max_batch, self.cache_len,
                                       abstract=True)
            cache = {k: torch.zeros(
                sharding.local_shape(t.shape, self._specs.cache[k],
                                     self.mesh),
                dtype=t.dtype, device=self.device) for k, t in ab.items()}
        # per-row positions: each slot decodes at its own offset
        cache["pos"] = torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=self.device)
        return cache

    def prompt_lines(self, r: Request) -> int:
        """The cache lines r's prompt takes: its tokens, and for vlm the
        n_vis_tokens patch lines before them."""
        vis = self.cfg.n_vis_tokens if self.cfg.family == "vlm" else 0
        return len(r.prompt) + vis

    def prefill_batch(self, r: Request, start: int = 0):
        """The batch that prefills r past its first `start` tokens (a
        restored prefix): the rest right-padded to the smallest bucket that
        fits the slot's lines past the prefix and the vis lines, and, with
        no prefix, r's extra inputs on the engine's device in their own
        dtype. The rows it prefills are the vis lines and its tokens'
        width."""
        prompt = np.asarray(r.prompt, np.int32)
        vis = self.prompt_lines(r) - len(prompt)
        n = len(prompt) - start
        toks = np.zeros((1, self._bucket_len(n, self.cache_len - start - vis)),
                        np.int64)
        toks[0, :n] = prompt[start:]         # right pad: masked by pos
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if r.extra and not start:
            batch.update({k: _extra_tensor(v, self.device)
                          for k, v in r.extra.items()})
        return batch

    def _admit(self, cache, slot_idx: int, r: Request, t_enqueue: float):
        """Prefill r into slot_idx's cache lines; returns
        (cache, slot state, first sampled token)."""
        plen = self.prompt_lines(r)
        # spec rounds write up to spec_k speculative lines past the
        # committed region before the accept rolls pos back, so a spec
        # engine reserves that headroom in every slot
        if plen + r.max_new_tokens + self.spec_k > self.cache_len:
            raise ValueError(f"request {r.rid}: prompt {plen} + max_new "
                             f"{r.max_new_tokens} + spec_k {self.spec_k} "
                             f"exceeds cache_len {self.cache_len}")
        # paged cache: open the block table and consult the prefix index;
        # a hit restores the cached pages into the slot row and prefills
        # only the unseen suffix
        prompt = np.asarray(r.prompt, np.int32)
        hit = None
        if self._kv is not None:
            hit = self._kv.admit(r.rid, prompt, plen, r.max_new_tokens)
        t_admit = time.perf_counter()
        start = hit.tokens if hit is not None else 0
        n = len(prompt) - start
        batch = self.prefill_batch(r, start)
        if hit is not None:
            cache = self._kv.restore_prefix(cache, slot_idx, hit)
            logits, cache = self.model.prefill_continue(
                self.params, cache, slot_idx, batch, start, n)
        else:
            logits, cache = self.model.prefill_into_slot(
                self.params, cache, slot_idx, batch, plen, **self._ctx_kw)
        if self._kv is not None and self._kv.prefix_reuse:
            # publish this prompt's full pages for future admissions
            cache = self._kv.insert_prefix(prompt, r.rid, cache, slot_idx)
        if self.spec_k:
            # the draft keeps its own slot-resident lines (the page pool
            # tracks committed target lines only) and prefills the whole
            # prompt; its first-token logits are discarded (the first
            # token is the target's)
            dtoks = np.zeros((1, self._bucket_len(plen, self.cache_len)),
                             np.int64)
            dtoks[0, :plen] = prompt
            _, self._draft_cache = self.draft_model.prefill_into_slot(
                self.draft_params, self._draft_cache, slot_idx,
                {"tokens": torch.from_numpy(dtoks).to(self.device)}, plen)
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
        self._reqs: Dict[int, Request] = {}      # in-flight rid -> Request
        self._t_enq: Dict[int, float] = {}
        self._out: Dict[int, List[int]] = {}
        self._per_req: Dict[int, RequestStats] = {}
        self._slots = [None] * self.max_batch
        self._cache = self._fresh_cache()
        if self.kv_page_size:
            self._kv = PagedKVCache(
                self.cfg, max_batch=self.max_batch,
                cache_len=self.cache_len, page_size=self.kv_page_size,
                n_pages=self.kv_pages, kv_dtype=self.kv_dtype,
                prefix_reuse=self.prefix_reuse, device=self.device)
        self._draft_cache = None
        if self.spec_k:
            dc = self.draft_model.init_cache(self.max_batch, self.cache_len,
                                             device=self.device)
            dc["pos"] = torch.zeros((self.max_batch,), dtype=torch.int32,
                                    device=self.device)
            self._draft_cache = dc
        self._spec_inflight = {}
        self._spec = {"proposed": 0, "accepted": 0, "rejected": 0,
                      "bonus": 0, "tokens_emitted": 0, "verify_steps": 0,
                      "draft_steps": 0}
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
    def kv(self) -> Optional[PagedKVCache]:
        """The run's PagedKVCache (None until reset() on a paged engine,
        always None with kv_page_size=0)."""
        return self._kv

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
        self._reqs[r.rid] = r
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
        self._reqs.pop(s.rid, None)
        if self._kv is not None:
            self._kv.release(s.rid)     # terminal outcome: free pages once
        return s.rid

    @backend.f32_accumulation()
    def step(self) -> StepReport:
        """One scheduler round: refill every free slot from the queue
        (each free slot index gets at most one admission attempt per
        round), then run one batched decode step over the occupied slots.
        With nothing occupied after admission the decode is skipped
        (decoded=0). The round runs under layers.exact_tp_scope (every
        rank of a sharded engine must step alike, and one without a mesh
        keeps the sharded order)."""
        with layers.exact_tp_scope(self.mesh, self._columns):
            return self._step()

    def _step(self) -> StepReport:
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
                    self._reqs.pop(r.rid, None)
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
        if self.spec_k:
            return self._spec_round(admitted, finished)
        active = np.array([s is not None for s in self._slots])
        logits, self._cache = _masked(
            lambda p, c, t: self.model.decode_step(p, c, t, **self._ctx_kw),
            self.params, self._cache, self._tokens(self._cur),
            self._active(active))
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
            if self._kv is not None:
                # decode growth: pos covers prompt_len + n_gen lines
                self._kv.grow(s.rid, s.prompt_len + s.n_gen)
            if s.remaining <= 0:
                finished.append(self._finish(i))
        return StepReport(admitted=admitted, finished=finished,
                          decoded=int(active.sum()),
                          queue_depth=len(self._queue))

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(toks, np.int64)).to(
            self.device)

    def _active(self, active: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(active).to(self.device)

    def _spec_round(self, admitted: List[int], finished: List[int]
                    ) -> StepReport:
        """One speculative scheduler round (in place of the plain batched
        decode when spec_k > 0): propose spec_k draft candidates per
        active slot, verify them all plus the committed current token in
        ONE target forward, accept host-side (serve/spec.py), then roll
        every slot's cache position back to its last accepted line.

        Position contract: a round starts with both caches' pos at the
        committed offset P = prompt_len + n_gen - 1 (cur's line unwritten,
        the plain-decode invariant). Propose advances the draft to
        P + spec_k + 1 (spec_k candidate feeds plus one catch-up feed that
        writes the last candidate's line, needed only on a full accept);
        verify advances the target to the speculated tip P + spec_k + 1.
        After accepting a tokens (+1 correction or bonus), BOTH roll back
        to P + a + 1. Rejected candidates' lines stay in the buffer beyond
        the committed region: invisible and overwritten by the step that
        first reaches them.

        Greedy rows need only the target argmax at each verify position,
        taken on the device; the logits of temperature rows come to the
        host for the float64 accept arithmetic."""
        k = self.spec_k
        slots = self._slots
        active = np.array([s is not None for s in slots])
        act = self._active(active)
        n_active = int(active.sum())
        base_gen = np.array([s.n_gen if s else 0 for s in slots])
        hot = [i for i, s in enumerate(slots) if s is not None
               and s.temperature > 0]
        # ---- propose: k sequential draft steps + the catch-up feed
        draft_toks = np.zeros((self.max_batch, k), np.int64)
        draft_logits = []
        feed = self._tokens(self._cur)
        for j in range(k):
            dlg, self._draft_cache = _masked(
                self.draft_model.decode_step, self.draft_params,
                self._draft_cache, feed, act)
            draft_toks[:, j] = self._draw(dlg, slots, base_gen + j,
                                          salt=spec_lib.SALT_DRAFT)
            if hot:
                draft_logits.append(dlg[:, 0].float().cpu().numpy())
            feed = self._tokens(draft_toks[:, j:j + 1])
        _, self._draft_cache = _masked(
            self.draft_model.decode_step, self.draft_params,
            self._draft_cache, feed, act)
        # ---- verify: one (k+1)-position target forward over
        # [cur, d_0..d_{k-1}]; device pos advances to the speculated tip,
        # recorded in _spec_inflight so an eviction before the accept
        # rolls back to the last accepted line
        for i, s in enumerate(slots):
            if s is not None:
                self._spec_inflight[i] = s.prompt_len + s.n_gen - 1
        vtoks = np.concatenate([self._cur, draft_toks], axis=1)
        vlg, self._cache = _masked(self.model.decode_verify, self.params,
                                   self._cache, self._tokens(vtoks), act)
        v_arg = vlg.argmax(dim=-1).cpu().numpy()
        v_hot = vlg[hot].float().cpu().numpy() if hot else None
        self._n_steps += 1
        self._slot_steps_active += n_active
        self._spec["verify_steps"] += n_active
        self._spec["draft_steps"] += n_active * (k + 1)
        self._spec["proposed"] += n_active * k
        # ---- accept + commit (host), then roll positions back
        new_pos = self._cache["pos"].cpu().numpy().copy()
        draft_pos = self._draft_cache["pos"].cpu().numpy().copy()
        for i, s in enumerate(slots):
            if s is None:
                continue
            if s.temperature > 0:
                h = hot.index(i)
                emitted, kinds = spec_lib.accept_tokens(
                    draft_toks[i], np.stack([d[i] for d in draft_logits]),
                    v_hot[h], temperature=s.temperature, base_key=self.rng,
                    rid=s.rid, n_gen=s.n_gen)
            else:
                emitted, kinds = spec_lib.accept_greedy(draft_toks[i],
                                                        v_arg[i])
            # cap at the request budget; counters follow the kept tokens
            # so accepted + rejected + bonus == tokens_emitted survives
            m = min(len(emitted), s.remaining)
            emitted, kinds = emitted[:m], kinds[:m]
            self._out[s.rid].extend(emitted)
            self._cur[i, 0] = emitted[-1]
            s.n_gen += m
            s.remaining -= m
            s.decode_steps += 1
            for kind in kinds:
                self._spec[kind] += 1
            self._spec["tokens_emitted"] += m
            committed = s.prompt_len + s.n_gen - 1
            new_pos[i] = committed
            draft_pos[i] = committed
            if self._kv is not None:
                # page accounting covers committed lines only: the
                # speculated tip is never page-backed
                self._kv.grow(s.rid, s.prompt_len + s.n_gen)
            self._spec_inflight.pop(i, None)
            if s.remaining <= 0:
                finished.append(self._finish(i))
        self._cache["pos"] = torch.from_numpy(new_pos).to(self.device)
        self._draft_cache["pos"] = torch.from_numpy(draft_pos).to(
            self.device)
        return StepReport(admitted=admitted, finished=finished,
                          decoded=n_active, queue_depth=len(self._queue))

    def evict_inflight(self, rids: Optional[Iterable[int]] = None
                       ) -> Tuple[List[Request], int]:
        """Pull unfinished requests (occupied slots first, then the
        waiting queue) OUT of the engine. Two callers:

          * failover (rids=None): a router fencing a dead replica evicts
            EVERYTHING so survivors can re-serve it;
          * targeted eviction (rids={...}): the router's deadline sweep
            removes exactly the expired requests; batch-mates keep
            decoding undisturbed (their sample keys are per-request).

        Partial outputs and timing of the evicted rids are discarded: a
        re-queued request restarts from scratch, and the per-request keys
        make the restart token-for-token identical to an undisturbed run.
        Returns (evicted requests, tokens thrown away). A freed slot's
        rows need no scrubbing while its held pos never overstates the
        row's committed content; a spec engine evicted between verify and
        accept holds the speculated tip, so its slot (and the draft's)
        rolls back to the last ACCEPTED line here. A paged engine
        releases an evicted slot's pages once (queued requests hold
        none)."""
        target = None if rids is None else set(rids)
        evicted: List[Request] = []
        wasted = 0
        for i, s in enumerate(self._slots):
            if s is None or (target is not None and s.rid not in target):
                continue
            if self.spec_k and self._cache is not None:
                # _spec_inflight holds the committed offset recorded at
                # verify launch; outside a round it is empty and the
                # fallback equals the device pos
                committed = self._spec_inflight.pop(
                    i, s.prompt_len + s.n_gen - 1)
                self._cache["pos"] = _set_row(self._cache["pos"], i,
                                              committed)
                self._draft_cache["pos"] = _set_row(
                    self._draft_cache["pos"], i, committed)
            evicted.append(self._reqs.pop(s.rid))
            wasted += len(self._out.pop(s.rid, []))
            self._t_enq.pop(s.rid, None)
            self._slots[i] = None
            if self._kv is not None:
                self._kv.release(s.rid)
        keep: deque = deque()
        while self._queue:
            r = self._queue.popleft()
            if target is not None and r.rid not in target:
                keep.append(r)
                continue
            evicted.append(self._reqs.pop(r.rid, r))
            wasted += len(self._out.pop(r.rid, []))
            self._t_enq.pop(r.rid, None)
        self._queue = keep
        self._n_submitted -= len(evicted)
        return evicted, wasted

    def device_stats(self) -> List[Dict[str, Any]]:
        """Per-rank shard accounting of a sharded engine ([] without a
        mesh): for every rank of the mesh, in rank order, the bytes of its
        local param shards and of its local cache. A collective on a mesh
        of several ranks: every rank calls it (finalize does)."""
        if self.mesh is None:
            return []
        mine = {"device": self.mesh.rank,
                "params_bytes": sum(_nbytes(t) for t in _leaves(self.params)),
                "cache_bytes": self._cache_bytes_local}
        if self.mesh.size == 1:
            return [mine]
        import torch.distributed as dist
        every: List[Any] = [None] * self.mesh.size
        dist.all_gather_object(every, mine)
        return every

    def finalize(self) -> Dict[str, Any]:
        """Aggregate this run's counters into the engine-stats dict (also
        stored on last_stats); a sharded engine adds "devices" and
        "per_device" (device_stats() with the run's occupancy and
        tokens/s)."""
        wall = time.perf_counter() - self._t_start
        engine_stats = aggregate_engine_stats(
            self._per_req, n_requests=self._n_submitted,
            n_steps=self._n_steps, n_prefills=self._n_prefills,
            slot_steps_active=self._slot_steps_active,
            max_batch=self.max_batch, wall_s=wall)
        if self.mesh is not None:
            per_dev = self.device_stats()
            engine_stats["devices"] = len(per_dev)
            engine_stats["per_device"] = [
                {**d, "occupancy": engine_stats["occupancy"],
                 "tok_per_s": engine_stats["tok_per_s"]}
                for d in per_dev]
        if self._kv is not None:
            # merged here, outside aggregate_engine_stats's schema
            engine_stats["kvcache"] = self._kv.stats()
        if self.spec_k and self._spec is not None:
            sp: Dict[str, Any] = dict(self._spec)
            sp["k"] = self.spec_k
            sp["acceptance_rate"] = (sp["accepted"] / sp["proposed"]
                                     if sp["proposed"] else 0.0)
            sp["accepted_tokens_per_step"] = (
                sp["tokens_emitted"] / sp["verify_steps"]
                if sp["verify_steps"] else 0.0)
            engine_stats["spec"] = sp
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


def _masked(step, params, cache, tokens, active: torch.Tensor):
    """One decode/verify step with done-row masking: rows that are not
    active keep their pos, so their rows stop growing (the step wrote
    masked, invisible lines there)."""
    old_pos = cache["pos"]
    logits, new = step(params, cache, tokens)
    new["pos"] = torch.where(active, new["pos"], old_pos)
    return logits, new


def _set_row(pos: torch.Tensor, i: int, value: int) -> torch.Tensor:
    pos = pos.clone()
    pos[i] = value
    return pos


def _extra_tensor(v, device) -> torch.Tensor:
    """A request's extra input on `device` in its own dtype (a numpy
    bfloat16 array by its 16-bit patterns)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return tensor_from_numpy(v, device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_params(tree, specs, abstract, mesh, device):
    """This rank's shards of the whole params `tree` on `device`: a split
    leaf's block copied into a tensor of its own (the whole leaf can then
    be freed), a replicated leaf moved as it is; a packed leaf
    (sharding.PackedSpec) keeps its block of each packed tensor. Raises
    ValueError on a leaf whose shape is not the whole tree's."""
    if isinstance(tree, dict):
        return {k: _local_params(tree[k], specs[k], abstract[k], mesh,
                                 device)
                for k in abstract}
    if tuple(tree.shape) != tuple(abstract.shape):
        raise ValueError(f"mesh=: a leaf of shape {tuple(tree.shape)} where "
                         f"the model has {tuple(abstract.shape)}: pass the "
                         f"whole params (the engine cuts each rank's shards)")
    if all(e is None for e in specs):
        return tree.to(device)
    block = sharding.local_shard(tree, specs, mesh)
    return torch.empty(block.shape, dtype=block.dtype,
                       device=device).copy_(block)
