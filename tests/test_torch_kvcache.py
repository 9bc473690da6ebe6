"""The port's paged K/V cache against the JAX package's
(`repro.serve.kvcache.PagedKVCache`) over the same call sequences: the
host accounting must match exactly — FIFO page ids, block tables, the
prefix index with its refcounts and eviction order, every counter and
`stats()` key by key, conservation, pool exhaustion, the release-once
assert and the hybrid fall-through. The page copies must match bit for
bit: published pages (bf16 copies, or int8 pages and their scales) and
the rows a hit restores; `quantize_page` and `dequantize_page` are
bit-equal to JAX's, ties rounding half to even."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.serve import kvcache as jkv
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.serve import kvcache as tkv

KW = dict(layers=2, d_model=64, vocab=128)


def _pair(arch="qwen2-1.5b", **kw):
    """A JAX and a port PagedKVCache built alike."""
    return (jkv.PagedKVCache(jreduce(jget(arch), **KW), **kw),
            tkv.PagedKVCache(reduce_config(get_config(arch), **KW),
                             device="cpu", **kw))


def _state(kv):
    """Every piece of host state the accounting consists of."""
    return (list(kv._free),
            {r: (t.shared, t.private, t.ctx_len)
             for r, t in kv._tables.items()},
            [(k, e.page_id, e.refcount) for k, e in kv._index.items()],
            kv._index_pages, kv.pages_allocated, kv.pages_freed,
            kv.peak_live, kv.prefix_lookups, kv.prefix_hits,
            kv.prefill_tokens_saved, kv._admitted, kv._pages_at_admit,
            kv.pageable, kv.prefix_reuse, kv.n_pages, kv.page_bytes())


def _same(jk, tk):
    assert _state(tk) == _state(jk)
    assert tk.stats() == jk.stats()


def _bits(x) -> np.ndarray:
    """Bit patterns of a jax or torch array, via numpy."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.element_size() == 2 else torch.int8
                      if x.element_size() == 1 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view({2: np.int16, 1: np.int8, 4: np.int32}[a.dtype.itemsize])


def _caches(cfg, max_batch, cache_len, seed):
    """The same random slot cache as a JAX dict and a torch dict."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, max_batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return ({"k": jnp.asarray(k).astype(jnp.bfloat16),
             "v": jnp.asarray(v).astype(jnp.bfloat16)},
            {"k": torch.from_numpy(k).to(torch.bfloat16),
             "v": torch.from_numpy(v).to(torch.bfloat16)})


def test_fifo_page_ids_and_conservation():
    jk, tk = _pair(max_batch=2, cache_len=32, page_size=8,
                   prefix_reuse=False)
    p1, p2 = np.arange(10, dtype=np.int32), np.arange(20, dtype=np.int32)
    for kv in (jk, tk):
        kv.admit(0, p1, len(p1), 4)
        kv.admit(1, p2, len(p2), 4)
    _same(jk, tk)
    assert tk._tables[1].pages() == [2, 3, 4]
    for kv in (jk, tk):
        kv.release(0)
        kv.check_conservation()
        kv.admit(2, p2, len(p2), 4)          # takes never-used ids first
    _same(jk, tk)
    assert tk._tables[2].pages() == [5, 6, 7]


def test_grow_and_release_exactly_once():
    jk, tk = _pair(max_batch=2, cache_len=32, page_size=4,
                   prefix_reuse=False)
    p = np.arange(6, dtype=np.int32)
    for kv in (jk, tk):
        kv.admit(0, p, len(p), 8)
        assert kv.grow(0, 8) == 0
        assert kv.grow(0, 9) == 1
        assert kv.grow(7, 9) == 0            # unknown rid: nothing
    _same(jk, tk)
    for kv in (jk, tk):
        kv.release(0)
        kv.check_conservation()
        with pytest.raises(AssertionError, match="released rid 0"):
            kv.release(0)
    _same(jk, tk)


def test_pool_exhaustion_raises():
    jk, tk = _pair(max_batch=1, cache_len=16, page_size=4, n_pages=2,
                   prefix_reuse=False)
    for kv in (jk, tk):
        kv.admit(0, np.arange(8, dtype=np.int32), 8, 1)
        with pytest.raises(RuntimeError, match="page pool exhausted"):
            kv.admit(1, np.arange(8, dtype=np.int32), 8, 1)
    _same(jk, tk)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_unpageable_families_fall_through(arch):
    jk, tk = _pair(arch, max_batch=2, cache_len=32, page_size=8)
    assert not tk.pageable and not tk.prefix_reuse and tk.pools == {}
    for kv in (jk, tk):
        assert kv.admit(0, np.arange(5, dtype=np.int32), 5, 4) is None
        kv.grow(0, 9)
        kv.release(0)
        kv.release(0)                        # no table: nothing to assert
        kv.check_conservation()
    _same(jk, tk)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_index_sequence_and_page_copies(kv_dtype):
    """Shared prefixes, hits and misses, publication, restore, release and
    eviction of unreferenced index pages in a pool small enough to force
    it: the host state after every call, and the pages and restored rows
    bit for bit."""
    page, cache_len, mb = 4, 32, 3
    jk, tk = _pair(max_batch=mb, cache_len=cache_len, page_size=page,
                   n_pages=12, kv_dtype=kv_dtype)
    jc, tc = _caches(jk.cfg, mb, cache_len, seed=1)
    rng = np.random.default_rng(2)
    sys_a, sys_b = (rng.integers(0, 128, 9).astype(np.int32)
                    for _ in range(2))
    prompts = [np.concatenate([sys_a, rng.integers(0, 128, n)]).astype(
        np.int32) for n in (3, 6, 1)]
    prompts += [np.concatenate([sys_b, rng.integers(0, 128, 5)]).astype(
        np.int32), prompts[0].copy(), sys_a[:5].copy(), sys_a.copy()]
    # (rid, prompt index, slot, release after admission of rid)
    plan = [(0, 0, 0, None), (1, 1, 1, None), (2, 3, 2, 0), (3, 2, 0, 1),
            (4, 4, 1, 2), (5, 5, 2, 3), (6, 6, 0, 4), (7, 1, 1, 5)]
    for rid, pi, slot, rel in plan:
        prompt = prompts[pi]
        hits = []
        for kv in (jk, tk):
            hits.append(kv.lookup_prefix(prompt))
        assert (None if hits[1] is None else vars(hits[1])) == \
            (None if hits[0] is None else vars(hits[0]))
        _same(jk, tk)
        hits = [kv.admit(rid, prompt, len(prompt), 3) for kv in (jk, tk)]
        assert (None if hits[1] is None else vars(hits[1])) == \
            (None if hits[0] is None else vars(hits[0]))
        if hits[0] is not None:
            jc = jk.restore_prefix(jc, slot, hits[0])
            tc = tk.restore_prefix(tc, slot, hits[1])
            for name in ("k", "v"):
                np.testing.assert_array_equal(_bits(tc[name]),
                                              _bits(jc[name]))
        jc = jk.insert_prefix(prompt, rid, jc, slot)
        tc = tk.insert_prefix(prompt, rid, tc, slot)
        for kv in (jk, tk):
            kv.grow(rid, len(prompt) + 2)
        _same(jk, tk)
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bits(tk.pools[name]),
                                          _bits(jk.pools[name]))
            if kv_dtype == "int8":
                np.testing.assert_array_equal(
                    tk.scales[name].numpy(), np.asarray(jk.scales[name]))
        if rel is not None:
            for kv in (jk, tk):
                kv.release(rel)
                kv.check_conservation()
            _same(jk, tk)
    assert tk.prefix_hits >= 3 and tk.pages_freed > 0
    for kv in (jk, tk):
        kv.release_all()
        kv.check_conservation()
    _same(jk, tk)
    assert tk.pages_live == tk._index_pages
    # every index page is unreferenced now: a prompt that needs two pages
    # more than the free list holds evicts the two oldest
    pinned = tk._index_pages
    long = rng.integers(0, 128, page * (tk.n_pages - pinned + 2)).astype(
        np.int32)
    for kv in (jk, tk):
        kv.admit(8, long, len(long), 1)
        kv.check_conservation()
    _same(jk, tk)
    assert tk._index_pages == pinned - 2
    hits = [kv.lookup_prefix(prompts[1]) for kv in (jk, tk)]
    assert (None if hits[1] is None else vars(hits[1])) == \
        (None if hits[0] is None else vars(hits[0]))
    _same(jk, tk)


def test_quantize_page_bit_equal_with_ties():
    rng = np.random.default_rng(3)
    pages = [rng.standard_normal((2, 8, 2, 16)).astype(np.float32),
             # amax 127 gives scale 1: x.5 values tie and round half to even
             np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                      np.float32).reshape(1, 8, 1, 1),
             np.zeros((1, 4, 1, 16), np.float32)]
    for x in pages:
        jq, js = jkv.quantize_page(jnp.asarray(x).astype(jnp.bfloat16))
        tq, ts = tkv.quantize_page(torch.from_numpy(x).to(torch.bfloat16))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        back_j = jkv.dequantize_page(jq, js)
        back_t = tkv.dequantize_page(tq, ts)
        np.testing.assert_array_equal(_bits(back_t), _bits(back_j))
    tq, _ = tkv.quantize_page(torch.from_numpy(pages[1]).to(torch.bfloat16))
    assert tq.flatten().tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_prompt_tokens_hash_as_int32_whatever_their_dtype():
    _, tk = _pair(max_batch=2, cache_len=32, page_size=4)
    prompt = np.arange(13)
    assert tkv._hash_tokens(prompt.astype(np.int64)) == \
        tkv._hash_tokens(prompt.astype(np.int32)) == jkv._hash_tokens(prompt)
