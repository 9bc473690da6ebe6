"""Paged K/V cache with prefix reuse for the slot scheduler — the port of
`repro.serve.kvcache` (:62-488).

  * `PagedKVCache` — fixed-size cache pages (`page_size` K/V lines per
    page, spanning every pageable leaf at one page id) with a per-request
    block table: pages are allocated at admission and as decode crosses
    page boundaries, and freed exactly once when the request finishes.
    The free list is a FIFO over page ids, so identical runs allocate
    identical pages.
  * Prefix reuse — prompt prefixes are hashed at page granularity into a
    chained index (`(depth, sha1(tokens[:depth*page]))` -> page id; the
    tokens hashed as int32 bytes whatever dtype the caller holds).
    Admission walks the chain; on a hit the cached pages are copied into
    the slot's cache rows and only the unseen suffix is prefilled
    (`Model.prefill_continue`). Shared pages are refcounted and
    read-only.
  * int8 pages (`kv_dtype="int8"`) — quantized on the way into the pool
    with one symmetric scale a page (`quantize_page`), dequantized on
    restore (`dequantize_page`).

The host side (free list, block tables, index, refcounts, eviction of the
oldest unreferenced index page, conservation and `stats()`) is the JAX
package's to the integer. The pools are torch tensors (L, n_pages, page,
KvH, Hd) on the engine's device, one per pageable leaf, and the page
copies are indexed in-place writes: `_copy_out` copies a slot's lines into
the pool (a copy, not a view: the slot's rows are overwritten later) and
`_copy_in` writes a page back into the slot's rows of the cache it is
given. Families whose decode state is not paged K/V (hybrid's window
ring, ssm) report `pageable=False` and the engine serves them unpaged.

As in the JAX package, the engine never runs the paged decode kernels:
decode reads the dense slot cache, and the pool holds the published
prefix pages (ROADMAP). The kernels are reached through
`dispatch("paged_decode", ...)`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import PARAM_DTYPE

INT8_MAX = 127.0

# cache leaves that hold full-context K/V lines, per family. hybrid's k/v
# is a window ring buffer (a page table over it would alias lines) and ssm
# has no K/V at all; encdec's xk/xv are whole-prompt cross-attention lines
# with no decode growth, left dense.
_PAGEABLE_LEAVES: Dict[str, Tuple[str, ...]] = {
    "dense": ("k", "v"),
    "vlm": ("k", "v"),
    "moe": ("k", "v", "dk", "dv"),
    "encdec": ("k", "v"),
}

# prefix reuse needs a suffix-prefill path whose result matches the cold
# prefill: pure-attention decoder-only stacks have one
# (Model.prefill_continue). Paging still applies to the others.
_PREFIX_FAMILIES = ("dense",)


def quantize_page(page: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with ONE scale per page. Returns
    (int8 page, f32 0-d scale); rounds half to even, as jnp.round."""
    f = page.float()
    scale = torch.clamp_min(f.abs().max(), 1e-8) / INT8_MAX
    q = torch.clamp(torch.round(f / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_page(q: torch.Tensor, scale: torch.Tensor,
                    dtype=PARAM_DTYPE) -> torch.Tensor:
    """Inverse of quantize_page (lossy)."""
    return (q.float() * scale).to(dtype)


def _hash_tokens(tokens: np.ndarray) -> str:
    return hashlib.sha1(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).hexdigest()


@dataclasses.dataclass
class _IndexEntry:
    """One shared prefix page: the `depth`-th page of some prompt chain."""
    page_id: int
    refcount: int = 0            # admitted requests currently mapping it


@dataclasses.dataclass
class _BlockTable:
    """Per-request page map: `shared` pages are index-owned prefix pages
    this request holds references on; `private` pages back its tail
    prompt lines and generated tokens."""
    shared: List[int]
    private: List[int]
    ctx_len: int                 # lines currently covered by allocation

    def pages(self) -> List[int]:
        return self.shared + self.private


@dataclasses.dataclass
class PrefixHit:
    """Admission-time prefix lookup result: the first `tokens` prompt
    positions are covered by cached pages `page_ids` (always fewer than
    the full prompt, so the last real token is still computed)."""
    tokens: int
    page_ids: List[int]


class PagedKVCache:
    """Page allocator + prefix index for one ServeEngine (see the module
    docstring).

    Example (dense family, CPU)::

        from repro_torch.configs.base import get_config, reduce_config
        from repro_torch.serve.kvcache import PagedKVCache
        cfg = reduce_config(get_config("qwen2-1.5b"), layers=2,
                            d_model=64, vocab=128)
        kv = PagedKVCache(cfg, max_batch=2, cache_len=64, page_size=8,
                          device="cpu")
        kv.admit(rid=0, prompt_tokens=None, prompt_len=10, max_new=6)
        kv.release(0)
        kv.check_conservation()
    """

    def __init__(self, cfg: ModelConfig, *, max_batch: int, cache_len: int,
                 page_size: int, n_pages: Optional[int] = None,
                 kv_dtype: str = "bf16", prefix_reuse: bool = True,
                 device=backend.DEFAULT_DEVICE):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        self.cfg = cfg
        self.page_size = page_size
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.kv_dtype = kv_dtype
        self.leaves = _PAGEABLE_LEAVES.get(cfg.family, ())
        if cfg.family == "moe" and not cfg.first_k_dense:
            self.leaves = ("k", "v")     # no dk/dv leaves in the cache
        self.pageable = bool(self.leaves)
        self.prefix_reuse = (prefix_reuse and self.pageable
                             and cfg.family in _PREFIX_FAMILIES)
        self.pages_per_slot = -(-cache_len // page_size)
        # worst case every slot fully grown, plus index headroom so a
        # standing shared prefix never starves slot growth
        self.n_pages = (n_pages if n_pages is not None
                        else (max_batch + 2) * self.pages_per_slot)

        # pools: one slab per pageable leaf, (L, n_pages, page, kvh, hd)
        dev = backend.resolve_device(device)
        pool_dtype = torch.int8 if kv_dtype == "int8" else PARAM_DTYPE
        self.pools: Dict[str, torch.Tensor] = {}
        self.scales: Dict[str, torch.Tensor] = {}
        self._leaf_layers: Dict[str, int] = {}
        L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        for name in self.leaves:
            ll = (cfg.first_k_dense if name in ("dk", "dv")
                  else (L - cfg.first_k_dense if cfg.family == "moe" else L))
            self._leaf_layers[name] = ll
            self.pools[name] = torch.zeros(
                (ll, self.n_pages, page_size, kvh, hd), dtype=pool_dtype,
                device=dev)
            if kv_dtype == "int8":
                self.scales[name] = torch.zeros((self.n_pages,),
                                                dtype=torch.float32,
                                                device=dev)

        # host accounting
        self._free: deque = deque(range(self.n_pages))
        self._tables: Dict[int, _BlockTable] = {}
        self._index: "OrderedDict[Tuple[int, str], _IndexEntry]" \
            = OrderedDict()
        self._index_pages = 0
        # conservation + stats counters
        self.pages_allocated = 0
        self.pages_freed = 0
        self.peak_live = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        self._admitted = 0
        self._pages_at_admit: List[int] = []

    # ------------------------------------------------------------ page math

    def page_bytes(self) -> int:
        """Device bytes of one page across every pageable leaf (pool dtype,
        plus the per-page scales for int8)."""
        total = 0
        for name in self.leaves:
            total += int(np.prod(self.pools[name].shape[2:])) \
                * self._leaf_layers[name] * self.pools[name].element_size()
            if self.kv_dtype == "int8":
                total += 4
        return total

    def static_bytes_per_slot(self) -> int:
        """What the static layout pins per slot: the full cache_len worth
        of pageable lines (the paging win's denominator)."""
        return self.pages_per_slot * self.page_bytes()

    @property
    def pages_live(self) -> int:
        return self.pages_allocated - self.pages_freed

    def check_conservation(self) -> None:
        """pages allocated == pages freed + pages live, and the free list
        accounts for every id not live."""
        live = sum(len(t.private) for t in self._tables.values()) \
            + self._index_pages
        assert self.pages_allocated == self.pages_freed + live, (
            f"page conservation violated: allocated={self.pages_allocated} "
            f"freed={self.pages_freed} live={live}")
        assert len(self._free) + live == self.n_pages, (
            f"free-list leak: free={len(self._free)} live={live} "
            f"total={self.n_pages}")

    def _alloc_page(self) -> int:
        if not self._free:
            self._evict_index_page()
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted: {self.n_pages} pages, "
                f"{self._index_pages} pinned by the prefix index")
        pid = self._free.popleft()
        self.pages_allocated += 1
        self.peak_live = max(self.peak_live, self.pages_live)
        return pid

    def _free_page(self, pid: int) -> None:
        self.pages_freed += 1
        self._free.append(pid)

    def _evict_index_page(self) -> None:
        """Drop the oldest unreferenced prefix page (insertion order). A
        missing link truncates its chain at lookup, so deeper entries just
        become unreachable and evictable later."""
        for key, ent in self._index.items():
            if ent.refcount == 0:
                del self._index[key]
                self._index_pages -= 1
                self._free_page(ent.page_id)
                return

    # ------------------------------------------------------- request lifecycle

    def lookup_prefix(self, prompt: np.ndarray) -> Optional[PrefixHit]:
        """Walk the page-granularity hash chain over `prompt`. The hit is
        capped below the full prompt so the suffix prefill always has at
        least one real token to produce logits from."""
        if not self.prefix_reuse:
            return None
        self.prefix_lookups += 1
        max_depth = (len(prompt) - 1) // self.page_size
        ids: List[int] = []
        for depth in range(1, max_depth + 1):
            key = (depth, _hash_tokens(prompt[: depth * self.page_size]))
            ent = self._index.get(key)
            if ent is None:
                break
            ids.append(ent.page_id)
        if not ids:
            return None
        self.prefix_hits += 1
        saved = len(ids) * self.page_size
        self.prefill_tokens_saved += saved
        return PrefixHit(tokens=saved, page_ids=ids)

    def admit(self, rid: int, prompt_tokens: Optional[np.ndarray],
              prompt_len: int, max_new: int) -> Optional[PrefixHit]:
        """Open `rid`'s block table: take references on any prefix hit,
        then allocate private pages covering the prompt tail. Returns the
        hit (None on a miss or an unpageable family)."""
        if not self.pageable:
            return None
        assert rid not in self._tables, f"rid {rid} already admitted"
        hit = (self.lookup_prefix(prompt_tokens)
               if prompt_tokens is not None else None)
        shared: List[int] = []
        if hit is not None:
            shared = list(hit.page_ids)
            for depth in range(1, len(shared) + 1):
                key = (depth,
                       _hash_tokens(prompt_tokens[: depth * self.page_size]))
                self._index[key].refcount += 1
        need = -(-prompt_len // self.page_size) - len(shared)
        private = [self._alloc_page() for _ in range(need)]
        self._tables[rid] = _BlockTable(shared=shared, private=private,
                                        ctx_len=prompt_len)
        self._admitted += 1
        self._pages_at_admit.append(len(shared) + len(private))
        return hit

    def grow(self, rid: int, ctx_len: int) -> int:
        """Decode growth: extend `rid`'s block table to cover `ctx_len`
        lines, allocating pages as generation crosses page boundaries.
        Returns how many pages were added."""
        t = self._tables.get(rid)
        if t is None:
            return 0
        have = len(t.shared) + len(t.private)
        need = -(-ctx_len // self.page_size)
        added = 0
        while have + added < need:
            t.private.append(self._alloc_page())
            added += 1
        t.ctx_len = max(t.ctx_len, ctx_len)
        return added

    def release(self, rid: int) -> None:
        """Terminal outcome for `rid`: free its private pages and drop its
        references on shared prefix pages — exactly once (a second release
        of the same rid asserts)."""
        if not self.pageable:
            return
        t = self._tables.pop(rid, None)
        assert t is not None, f"release of unadmitted/released rid {rid}"
        for pid in t.private:
            self._free_page(pid)
        # shared pages stay index-owned; the refcount only gates eviction
        for pid in t.shared:
            for ent in self._index.values():
                if ent.page_id == pid:
                    assert ent.refcount > 0, f"refcount underflow page {pid}"
                    ent.refcount -= 1
                    break

    def release_all(self) -> None:
        """Free every open block table (engine reset)."""
        for rid in list(self._tables):
            self.release(rid)

    # -------------------------------------------------------- prefix pages

    def insert_prefix(self, prompt: np.ndarray, rid: int, cache: Any,
                      slot: int) -> Any:
        """After a cold (or suffix) prefill of `slot`, publish the prompt's
        full pages into the index: each unseen depth gets a fresh page,
        the slot's K/V lines are copied into it (quantized when the pool
        is int8), and the admitting request takes a reference. Returns the
        (unchanged) cache."""
        if not self.prefix_reuse:
            return cache
        t = self._tables[rid]
        full_pages = (len(prompt) - 1) // self.page_size
        for depth in range(len(t.shared) + 1, full_pages + 1):
            key = (depth, _hash_tokens(prompt[: depth * self.page_size]))
            if key in self._index:
                ent = self._index[key]
            else:
                pid = self._alloc_page()
                self._index[key] = ent = _IndexEntry(page_id=pid)
                self._index_pages += 1
                self._copy_out(cache, slot, depth - 1, pid)
            ent.refcount += 1
            t.shared.append(ent.page_id)
            # the depth is now backed by a shared page; retire one private
            # page that covered it
            if t.private:
                self._free_page(t.private.pop())
        return cache

    def restore_prefix(self, cache: Any, slot: int, hit: PrefixHit) -> Any:
        """Copy a prefix hit's pages back into `slot`'s cache rows (the
        inverse of insert_prefix; dequantizes int8 pools), in place."""
        for j, pid in enumerate(hit.page_ids):
            self._copy_in(cache, slot, j, pid)
        return cache

    # ---------------------------------------------------------- page movement

    def _copy_out(self, cache, slot: int, page_idx: int, pid: int) -> None:
        start = page_idx * self.page_size
        for name in self.leaves:
            src = cache[name][:, slot, start:start + self.page_size]
            if self.kv_dtype == "int8":
                q, sc = quantize_page(src)
                self.pools[name][:, pid] = q
                self.scales[name][pid] = sc
            else:
                self.pools[name][:, pid] = src.to(self.pools[name].dtype)

    def _copy_in(self, cache, slot: int, page_idx: int, pid: int) -> None:
        start = page_idx * self.page_size
        for name in self.leaves:
            dst = cache[name][:, slot, start:start + self.page_size]
            page = self.pools[name][:, pid]
            if self.kv_dtype == "int8":
                page = dequantize_page(page, self.scales[name][pid],
                                       dst.dtype)
            dst.copy_(page)

    # ---------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """The engine's `last_stats["kvcache"]` block."""
        mean_pages = (float(np.mean(self._pages_at_admit))
                      if self._pages_at_admit else 0.0)
        static_b = self.static_bytes_per_slot()
        bytes_slot = mean_pages * self.page_bytes()
        return {
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "pages_allocated": self.pages_allocated,
            "pages_freed": self.pages_freed,
            "pages_live": self.pages_live,
            "peak_live_pages": self.peak_live,
            "page_occupancy": self.peak_live / self.n_pages,
            "index_pages": self._index_pages,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else 0.0),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "kv_bytes_per_slot": bytes_slot,
            "static_bytes_per_slot": static_b,
            "bytes_per_slot_reduction": (1.0 - bytes_slot / static_b
                                         if static_b else 0.0),
            "kv_dtype": self.kv_dtype,
        }
