"""The port's speculative decoding against the JAX package's, on the same
weights (carried across with convert.params_from_numpy) and requests:

  * `spec.accept_tokens` equal to the reference's on the same numpy
    logits, at temperature 0 and > 0 (the draws are the same Threefry
    bits, so the emitted tokens and their kinds are equal);
  * `transformer.attn_block_decode_k` and `Model.decode_verify`: logits
    within LOGIT_ATOL and cache lines within KV_ULPS of JAX's
    (tests/test_torch_model.py's tolerances), the port's verify within
    LOGIT_ATOL of Q sequential decode_step calls, and a line past the
    cache end dropped as the JAX one-hot select drops it;
  * the spec engine (and the plain engine) replaying the JAX engine's
    model outputs, on tests/test_spec_decode.py's qwen_pair and phi_pair
    at k 1, 2 and 4 and temperatures 0 and 0.8: every model call the port
    engine makes has the JAX call's tokens and per-row positions, and it
    is answered with the JAX call's logits; the tokens, the StepReports
    and stats["spec"] must then be equal. This holds the scheduler, the
    sampler, the key schedule, the accept loop and the rollback exactly.
    (Run on their own bf16 numerics, the two packages' models differ by
    ~3e-3 in the logits at this size, and these fixtures hold top-2 gaps
    down to 6e-4 at temperature 0 and Gumbel and accept margins down to
    ~1.5e-2 at 0.8, so a run on each package's own logits cannot be held
    token for token under a stated margin; the model's numerics are held
    by the decode_verify tests, and phi_pair, whose greedy margins clear
    the tolerance, also runs end to end on the port's own model.)
  * the port's own contracts: spec equal to plain greedy decoding token
    for token, a self-draft accepting everything, batch-mate
    independence, the refusals, paged composition with page
    conservation, and a mid-verify eviction rolling back to the last
    accepted line."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _prop import given, settings, st
from _torch_replay import Replay
from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models import transformer as JT
from repro.models.registry import build_model as jbuild
from repro.serve import spec as jspec
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.serve import rng
from repro_torch.serve import spec as tspec
from repro_torch.serve.engine import Request, ServeEngine

VOCAB = 128
LOGIT_ATOL = 2e-2           # tests/test_torch_model.py
KV_ULPS = 4 * 2.0 ** -7
SERVE_TOL = 1e-2            # tests/test_torch_serve.py


def _pair(arch, *, layers=2, d_model=64, seed):
    jcfg = jreduce(jget(arch), layers=layers, d_model=d_model, vocab=VOCAB)
    tcfg = reduce_config(get_config(arch), layers=layers, d_model=d_model,
                         vocab=VOCAB)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def qwen_pair():
    """tests/test_spec_decode.py's qwen pair: reduced qwen2.5-32b (seed 0)
    drafted by a one-layer reduced qwen2-1.5b (seed 1)."""
    return (_pair("qwen2.5-32b", seed=0),
            _pair("qwen2-1.5b", layers=1, seed=1))


@pytest.fixture(scope="module")
def phi_pair():
    return (_pair("phi4-mini-3.8b", seed=0),
            _pair("phi4-mini-3.8b", layers=1, d_model=32, seed=2))


def _requests(cls, n=4, max_new=8, temperature=0.0):
    """tests/test_spec_decode.py's _requests, for either package."""
    rng_ = np.random.RandomState(3)
    return [cls(rid=i, prompt=rng_.randint(0, VOCAB, size=3 + (i % 4)),
                max_new_tokens=max_new, temperature=temperature)
            for i in range(n)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ accept core

@settings(max_examples=16, deadline=None)
@given(seed=st.integers(0, 1 << 16), k=st.sampled_from([1, 2, 4]),
       temperature=st.sampled_from([0.0, 0.5, 0.8, 1.0]))
def test_accept_tokens_matches_jax(seed, k, temperature):
    """The same numpy logits through both accept cores: equal emitted
    tokens and kinds (the accounting identity with them)."""
    r = np.random.RandomState(seed)
    draft_toks = r.randint(0, VOCAB, size=k)
    draft_logits = (r.randn(k, VOCAB) * 2).astype(np.float32)
    target_logits = (r.randn(k + 1, VOCAB) * 2).astype(np.float32)
    # half the cases: the draft proposes the target's likeliest tokens,
    # so acceptances and bonus draws happen too
    if seed % 2:
        draft_toks = np.argmax(target_logits[:k], axis=-1)
        draft_logits = target_logits[:k] * 0.9
    kw = dict(temperature=temperature, rid=seed % 7, n_gen=seed % 11)
    want = jspec.accept_tokens(draft_toks, draft_logits, target_logits,
                               base_key=jax.random.PRNGKey(seed % 5), **kw)
    got = tspec.accept_tokens(draft_toks, draft_logits, target_logits,
                              base_key=rng.prng_key(seed % 5, device="cpu"),
                              **kw)
    assert got == want
    c = Counter(got[1])
    assert c["accepted"] + c["rejected"] + c["bonus"] == len(got[0])


def test_accept_greedy_is_the_greedy_branch():
    t = np.array([[0, 5, 1], [0, 1, 9], [3, 0, 0]], np.float32)
    assert tspec.accept_greedy([1, 2], [1, 2, 0]) == (
        [1, 2, 0], ["accepted", "accepted", "bonus"])
    assert tspec.accept_greedy([1, 1], np.argmax(t, -1)) == (
        [1, 2], ["accepted", "rejected"])


# ------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def dense():
    return _pair("qwen2-1.5b", seed=0)


def _slot_caches(dense, lens, cache_len=24):
    """Both packages' (B,) per-row slot caches after prefilling row b with
    lens[b] tokens (0 = empty row)."""
    jcfg, tcfg, jp, tp = dense
    jm, tm = jbuild(jcfg), build_model(tcfg)
    b = len(lens)
    jc = jm.init_cache(b, cache_len)
    jc["pos"] = jnp.zeros((b,), jnp.int32)
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    for slot, n in enumerate(lens):
        if not n:
            continue
        toks = np.random.default_rng(slot).integers(0, VOCAB, (1, n)).astype(
            np.int32)
        _, jc = jm.prefill_into_slot(jp, jc, slot, {"tokens": jnp.asarray(toks)},
                                     n)
        _, tc = tm.prefill_into_slot(tp, tc, slot, {"tokens": _t(toks).long()},
                                     n)
    return jm, tm, jc, tc


def _kv_close(t, j):
    t, j = t.float().numpy(), np.asarray(j, np.float32)
    assert np.max(np.abs(t - j)) <= KV_ULPS * np.max(np.abs(j))


@pytest.mark.parametrize("q", [1, 3, 5])
def test_decode_verify_matches_jax(dense, q):
    jcfg, tcfg, jp, tp = dense
    jm, tm, jc, tc = _slot_caches(dense, (7, 0, 12))
    toks = np.random.default_rng(q).integers(0, VOCAB, (3, q)).astype(
        np.int32)
    jl, jc2 = jm.decode_verify(jp, jc, jnp.asarray(toks))
    tl, tc2 = tm.decode_verify(tp, tc, _t(toks).long())
    assert tl.shape == (3, q, VOCAB) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tc2["pos"].numpy(), np.asarray(jc2["pos"]))
    assert tc2["pos"].tolist() == [7 + q, q, 12 + q]
    _kv_close(tc2["k"], jc2["k"])
    _kv_close(tc2["v"], jc2["v"])


def test_attn_block_decode_k_matches_jax(dense):
    jcfg, tcfg, jp, tp = dense
    _, _, jc, tc = _slot_caches(dense, (5, 9))
    x = (np.random.default_rng(0).standard_normal((2, 4, 64)) * 0.5).astype(
        np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    jo, (jk, jv) = JT.attn_block_decode_k(jlp, jx, jcfg, cache_k=jc["k"][0],
                                          cache_v=jc["v"][0], pos=jc["pos"])
    ck, cv = tc["k"][0].clone(), tc["v"][0].clone()
    to, (tk, tv) = TT.attn_block_decode_k(tlp, _t(x).to(torch.bfloat16),
                                          tcfg, cache_k=ck, cache_v=cv,
                                          pos=tc["pos"])
    assert tk is ck and tv is cv                     # written in place
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=LOGIT_ATOL,
                               rtol=0)
    _kv_close(tk, jk)
    _kv_close(tv, jv)


def test_decode_verify_equals_sequential_decode_steps(dense):
    """The verify identity in the port: Q candidates in one forward give
    what Q decode_step calls give on a copy of the cache."""
    _, tcfg, _, tp = dense
    _, tm, _, tc = _slot_caches(dense, (6, 11))
    toks = np.random.default_rng(9).integers(0, VOCAB, (2, 4))
    seq = {k: v.clone() for k, v in tc.items()}
    vl, vc = tm.decode_verify(tp, tc, _t(toks).long())
    for j in range(4):
        sl, seq = tm.decode_step(tp, seq, _t(toks[:, j:j + 1]).long())
        np.testing.assert_allclose(vl[:, j].numpy(), sl[:, 0].numpy(),
                                   atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(vc["pos"].numpy(), seq["pos"].numpy())
    _kv_close(vc["k"], seq["k"].float().numpy())


def test_verify_lines_past_the_cache_end_are_dropped(dense):
    """Row 0 at pos L-2 verifies Q=4 candidates: its last two lines fall
    past the end; both packages drop them, leaving every other line of
    the row (and the other row) as it was."""
    jcfg, tcfg, jp, tp = dense
    lc = 16
    jm, tm, jc, tc = _slot_caches(dense, (lc - 2, 3), cache_len=lc)
    before = tc["k"].clone()
    toks = np.random.default_rng(2).integers(0, VOCAB, (2, 4)).astype(
        np.int32)
    jl, jc2 = jm.decode_verify(jp, jc, jnp.asarray(toks))
    tl, tc2 = tm.decode_verify(tp, tc, _t(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    _kv_close(tc2["k"], jc2["k"])
    _kv_close(tc2["v"], jc2["v"])
    # row 0: lines 0..L-3 untouched, L-2 and L-1 written; row 1: 0..2
    # untouched, 3..6 written, the rest untouched
    assert torch.equal(tc2["k"][:, 0, :lc - 2], before[:, 0, :lc - 2])
    assert not torch.equal(tc2["k"][:, 0, lc - 2:], before[:, 0, lc - 2:])
    assert torch.equal(tc2["k"][:, 1, :3], before[:, 1, :3])
    assert torch.equal(tc2["k"][:, 1, 7:], before[:, 1, 7:])
    assert tc2["pos"].tolist() == [lc + 2, 7]


def test_hybrid_has_no_decode_verify():
    cfg = reduce_config(get_config("hymba-1.5b"), layers=1, d_model=64,
                        vocab=VOCAB)
    assert build_model(cfg).decode_verify is None
    assert jbuild(jreduce(jget("hymba-1.5b"), layers=1, d_model=64,
                          vocab=VOCAB)).decode_verify is None


# ---------------------------------------------- the engine, on JAX's logits

def _stepwise(eng, reqs):
    eng.reset()
    for r in reqs:
        eng.submit(r, t_enqueue=0.0)
    reports = []
    while not eng.idle:
        rep = eng.step()
        reports.append((rep.admitted, rep.finished, rep.decoded,
                        rep.queue_depth))
    return reports, eng.finalize()


def _replayed(pair, k, temperature, reqs=None):
    (jcfg, tcfg, jp, tp), (jdc, tdc, jdp, tdp) = pair
    kw = dict(max_batch=2, cache_len=64, rng_seed=0)
    spec_j = dict(draft_cfg=jdc, draft_params=jdp, spec_k=k) if k else {}
    spec_t = dict(draft_cfg=tdc, draft_params=tdp, spec_k=k) if k else {}
    jeng = JEngine(jcfg, jp, **kw, **spec_j)
    teng = ServeEngine(tcfg, tp, device="cpu", **kw, **spec_t)
    rec = Replay()
    rec.record(jeng)
    jrep, jstats = _stepwise(jeng, reqs or _requests(JRequest,
                                                     temperature=temperature))
    rec.replay(teng)
    treqs = [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                     max_new_tokens=r.max_new_tokens,
                     temperature=r.temperature)
             for r in (reqs or _requests(JRequest, temperature=temperature))]
    trep, tstats = _stepwise(teng, treqs)
    rec.check_all_used()
    return jeng, teng, jrep, trep, jstats, tstats


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("pair", ["qwen_pair", "phi_pair"])
def test_spec_engine_equals_jax_on_its_logits(pair, k, temperature, request):
    jeng, teng, jrep, trep, jstats, tstats = _replayed(
        request.getfixturevalue(pair), k, temperature)
    assert trep == jrep
    assert teng.outputs == jeng.outputs
    assert tstats["spec"] == jstats["spec"]
    for key in ("requests", "decode_steps", "prefills", "new_tokens",
                "occupancy"):
        assert tstats[key] == jstats[key], key
    sp = tstats["spec"]
    assert sp["accepted"] + sp["rejected"] + sp["bonus"] \
        == sp["tokens_emitted"] == sum(map(len, teng.outputs.values())) - 4


@pytest.mark.parametrize("temperature", [0.7, 1.1])
def test_plain_engine_samples_jax_tokens(qwen_pair, temperature):
    """The plain engine at temperature > 0 draws the JAX engine's token
    stream (fold_in(fold_in(PRNGKey(seed), rid), n_gen) categorical) on
    the JAX logits; mixed greedy and sampled rows, more requests than
    slots."""
    r = np.random.RandomState(8)
    reqs = [JRequest(rid=i, prompt=r.randint(0, VOCAB, size=2 + i),
                     max_new_tokens=3 + i,
                     temperature=0.0 if i == 2 else temperature)
            for i in range(5)]
    jeng, teng, jrep, trep, jstats, tstats = _replayed(qwen_pair, 0, None,
                                                       reqs)
    assert trep == jrep
    assert teng.outputs == jeng.outputs


# ---------------------------------------------- the engine, on its own model

def _spec(pair, k, **kw):
    (_, tcfg, _, tp), (_, tdc, _, tdp) = pair
    return ServeEngine(tcfg, tp, max_batch=2, cache_len=64, rng_seed=0,
                       device="cpu", draft_cfg=tdc, draft_params=tdp,
                       spec_k=k, **kw)


def _plain(pair, **kw):
    (_, tcfg, _, tp), _ = pair
    return ServeEngine(tcfg, tp, max_batch=2, cache_len=64, rng_seed=0,
                       device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("pair", ["qwen_pair", "phi_pair"])
def test_spec_bit_exact_vs_plain_greedy(pair, k, request):
    """tests/test_spec_decode.py:65 for the port: spec decoding emits the
    plain greedy chain token for token, on the port's own model."""
    p = request.getfixturevalue(pair)
    want = _plain(p).run(_requests(Request))
    eng = _spec(p, k)
    assert eng.run(_requests(Request)) == want
    sp = eng.last_stats["spec"]
    assert sp["k"] == k and sp["tokens_emitted"] > 0
    assert sp["accepted"] + sp["rejected"] + sp["bonus"] \
        == sp["tokens_emitted"]


def test_phi_spec_engine_equals_jax_on_its_own_model(phi_pair,
                                                     monkeypatch):
    """End to end on each package's own model at temperature 0 (phi_pair's
    greedy margins clear the tolerance): every verify and draft logit the
    two engines see within SERVE_TOL, every top-2 gap above it, and the
    tokens and stats["spec"] equal."""
    (jcfg, _, jp, _), (jdc, _, jdp, _) = phi_pair
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=64, draft_cfg=jdc,
                   draft_params=jdp, spec_k=2)
    teng = _spec(phi_pair, 2)
    jlog, tlog = [], []

    def wrap(obj, attr, store):
        inner = getattr(obj, attr)

        def call(*args):
            logits, new = inner(*args)
            store.append(np.array(logits.float() if isinstance(
                logits, torch.Tensor) else logits, np.float32))
            return logits, new
        monkeypatch.setattr(obj, attr, call)

    wrap(jeng, "_draft_decode", jlog)
    wrap(jeng, "_verify", jlog)
    wrap(teng.draft_model, "decode_step", tlog)
    wrap(teng.model, "decode_verify", tlog)
    want = jeng.run(_requests(JRequest))
    got = teng.run(_requests(Request))
    assert len(tlog) == len(jlog)
    for t, j in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, atol=SERVE_TOL, rtol=0)
        top2 = np.sort(j, axis=-1)[..., -2:]
        assert np.all(top2[..., 1] - top2[..., 0] > SERVE_TOL)
    assert got == want
    assert teng.last_stats["spec"] == jeng.last_stats["spec"]


def test_spec_self_draft_accepts_everything(qwen_pair):
    (_, tcfg, _, tp), _ = qwen_pair
    reqs = _requests(Request, n=2, max_new=9)
    want = _plain(qwen_pair).run(reqs)
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=64, device="cpu",
                      draft_cfg=tcfg, draft_params=tp, spec_k=2)
    assert eng.run(reqs) == want
    sp = eng.last_stats["spec"]
    assert sp["rejected"] == 0
    assert sp["acceptance_rate"] == 1.0
    assert sp["accepted_tokens_per_step"] > 1.0


def test_spec_batch_mate_independence(qwen_pair):
    """A spec slot next to others (a temperature slot among them) emits
    what it emits alone."""
    r = np.random.RandomState(5)
    reqs = [Request(rid=0, prompt=r.randint(0, VOCAB, size=4),
                    max_new_tokens=8),
            Request(rid=1, prompt=r.randint(0, VOCAB, size=6),
                    max_new_tokens=5, temperature=0.7),
            Request(rid=2, prompt=r.randint(0, VOCAB, size=3),
                    max_new_tokens=7)]
    batched = _spec(qwen_pair, 2).run(list(reqs))
    for req in reqs:
        assert _spec(qwen_pair, 2).run([req])[req.rid] == batched[req.rid]


def test_spec_refusals(qwen_pair):
    """tests/test_spec_decode.py:124 and the engine's other refusals: a
    missing draft, a vocabulary mismatch, a non-dense draft, a target
    without decode_verify, mesh=; and the spec_k headroom at admission."""
    (_, tcfg, _, tp), (_, tdc, _, tdp) = qwen_pair
    with pytest.raises(ValueError, match="draft_cfg"):
        ServeEngine(tcfg, tp, spec_k=2, device="cpu")
    bad = reduce_config(get_config("qwen2-1.5b"), layers=1, d_model=32,
                        vocab=VOCAB + 1)
    bad_p = build_model(bad).init_params(0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(tcfg, tp, draft_cfg=bad, draft_params=bad_p, spec_k=2,
                    device="cpu")
    hy = reduce_config(get_config("hymba-1.5b"), layers=1, d_model=64,
                       vocab=VOCAB)
    hy_p = build_model(hy).init_params(0, device="cpu")
    with pytest.raises(ValueError, match="dense decoder"):
        ServeEngine(tcfg, tp, draft_cfg=hy, draft_params=hy_p, spec_k=2,
                    device="cpu")
    with pytest.raises(ValueError, match="decode_verify"):
        ServeEngine(hy, hy_p, draft_cfg=tdc, draft_params=tdp, spec_k=2,
                    device="cpu")
    with pytest.raises(ValueError, match="speculative decoding"):
        ServeEngine(tcfg, tp, draft_cfg=tdc, draft_params=tdp, spec_k=2,
                    mesh=object(), device="cpu")
    eng = _spec(qwen_pair, 4)
    with pytest.raises(ValueError, match="spec_k"):
        eng.run([Request(rid=0, prompt=np.arange(50) % VOCAB,
                         max_new_tokens=11)])        # 50 + 11 + 4 > 64


def test_spec_composes_with_paged_cache(qwen_pair):
    """Spec + paged K/V: draft lines are slot-resident, pages cover
    committed target lines only; the tokens stay the plain chain and the
    pages are conserved."""
    want = _plain(qwen_pair).run(_requests(Request))
    eng = _spec(qwen_pair, 2, kv_page_size=8)
    assert eng.run(_requests(Request)) == want
    eng.kv.check_conservation()
    assert eng.kv.pages_live == eng.kv._index_pages
    assert eng.last_stats["kvcache"]["pages_allocated"] > 0


def test_evict_mid_verify_rolls_back_to_last_accepted(qwen_pair):
    """tests/test_spec_decode.py:327 for the port: a verify launched but
    never accepted (device pos at the speculated tip); evict_inflight
    rolls both caches back to the last accepted line, and the evicted
    request re-serves the plain chain."""
    eng = _spec(qwen_pair, 4)
    eng.reset()
    eng.submit(Request(rid=7, prompt=np.arange(5), max_new_tokens=8))
    eng.step()                                 # admission + one spec round
    s = eng._slots[0]
    assert s is not None and s.rid == 7
    committed = s.prompt_len + s.n_gen - 1
    assert int(eng._cache["pos"][0]) == committed

    active = torch.tensor([st_ is not None for st_ in eng._slots])
    eng._spec_inflight[0] = committed
    vtoks = np.zeros((eng.max_batch, eng.spec_k + 1), np.int64)
    vtoks[:, 0:1] = eng._cur
    with torch.no_grad():
        _, eng._cache = eng.model.decode_verify(eng.params, eng._cache,
                                                torch.from_numpy(vtoks))
        _, eng._draft_cache = eng.draft_model.decode_step(
            eng.draft_params, eng._draft_cache, torch.from_numpy(eng._cur))
    assert int(eng._cache["pos"][0]) == committed + eng.spec_k + 1
    assert bool(active[0])

    evicted, wasted = eng.evict_inflight(rids={7})
    assert [r.rid for r in evicted] == [7] and wasted == s.n_gen
    assert int(eng._cache["pos"][0]) == committed
    assert int(eng._draft_cache["pos"][0]) == committed
    assert eng.idle and eng._spec_inflight == {}

    want = _plain(qwen_pair).run([Request(rid=7, prompt=np.arange(5),
                                          max_new_tokens=8)])
    eng.submit(evicted[0])
    while not eng.idle:
        eng.step()
    assert eng.outputs[7] == want[7]


def test_evict_inflight_targets_and_releases_pages_once(qwen_pair):
    """Targeted eviction keeps batch-mates and the queue order; a paged
    engine releases an evicted slot's pages once, and a full eviction
    empties the engine with pages conserved."""
    eng = _plain(qwen_pair, kv_page_size=8)
    eng.reset()
    reqs = _requests(Request, n=4)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert [s.rid for s in eng._slots] == [0, 1]
    freed = eng.kv.stats()["pages_freed"]
    evicted, wasted = eng.evict_inflight(rids={1, 3})
    assert [r.rid for r in evicted] == [1, 3]
    assert wasted == 2                          # rid 1's two tokens
    assert [r.rid for r in eng._queue] == [2]
    assert eng.kv.stats()["pages_freed"] > freed
    eng.kv.check_conservation()
    evicted, _ = eng.evict_inflight()
    assert [r.rid for r in evicted] == [0, 2]
    assert eng.idle and eng.kv.pages_live == eng.kv._index_pages
    eng.kv.check_conservation()
    assert eng.finalize()["requests"] == 0
