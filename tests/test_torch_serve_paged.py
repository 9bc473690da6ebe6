"""The port's paged serving engine (`ServeEngine(kv_page_size=...)`)
against the JAX package's on the same weights and requests — the shared
system-prompt trace of tests/test_kvcache.py (PREFIX_TRACE): every
StepReport and the `kvcache` stats must be equal (host logic), and the
greedy tokens equal under tests/test_torch_serve.py's top-2 margin rule;
`Model.prefill_continue` against JAX's on restored rows; the hybrid
family falls through to the unpaged path; the int8 engine's accounting;
`prefix_reuse=False` serves the unpaged engine's tokens; and `mesh=` with
paging raises.

Tolerances: logits within SERVE_TOL = 1e-2 of JAX's (bf16 activations;
tests/test_torch_serve.py), with each compared step's top-2 margin above
it so the argmax cannot flip; prefill_continue's logits within
SERVE_TOL, its first layer's K/V rows within one bf16 ulp of JAX's (the
same arithmetic on the same embeddings, rounded once) and every layer's
within SERVE_TOL of the largest (a deeper layer's input carries the bf16
differences of the layers before it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.trace import TraceConfig, generate_trace
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import convert
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine

from _torch_replay import record_sampled_logits

SERVE_TOL = 1e-2
KW = dict(layers=2, d_model=64, vocab=128)
# tests/test_kvcache.py:43
PREFIX_TRACE = TraceConfig(
    n_requests=12, rate_rps=16.0, prompt_median=6, prompt_sigma=0.6,
    prompt_max=16, out_median=6, out_sigma=0.6, out_max=12,
    temperatures=(0.0,), vocab=128, seed=3,
    shared_prefix_frac=0.8, prefix_pool=2, prefix_len=16)


@pytest.fixture(scope="module")
def small():
    jcfg = jreduce(jget("qwen2-1.5b"), **KW)
    tcfg = reduce_config(get_config("qwen2-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def trace_requests():
    return generate_trace(PREFIX_TRACE).plain_requests()


def _port(reqs):
    return [Request(rid=r.rid, prompt=np.asarray(r.prompt),
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature) for r in reqs]


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


def _margin_rule(tlog, jlog):
    assert set(tlog) == set(jlog)
    for k, want in jlog.items():
        np.testing.assert_allclose(tlog[k], want, atol=SERVE_TOL, rtol=0)
        top2 = np.sort(want)[-2:]
        assert top2[1] - top2[0] > SERVE_TOL, (k, top2)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_engine_matches_jax(small, trace_requests, monkeypatch,
                                  kv_dtype):
    """The schedule, the kvcache stats (hits, tokens saved, pages) and the
    greedy tokens; int8 pools restore dequantized prefix pages, bit-equal
    in both packages, so the same rule holds."""
    jcfg, tcfg, jp, tp = small
    kw = dict(max_batch=4, cache_len=64, kv_page_size=8, kv_dtype=kv_dtype)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServeEngine(tcfg, tp, device="cpu", **kw)
    jlog, tlog = {}, {}
    record_sampled_logits(monkeypatch, jeng, jlog)
    record_sampled_logits(monkeypatch, teng, tlog)
    jrep, jstats = _stepwise(jeng, trace_requests)
    trep, tstats = _stepwise(teng, _port(trace_requests))
    assert trep == jrep
    assert tstats["kvcache"] == jstats["kvcache"]
    assert tstats["kvcache"]["prefix_hits"] > 0
    assert tstats["kvcache"]["kv_dtype"] == kv_dtype
    for key in ("requests", "decode_steps", "prefills", "new_tokens",
                "occupancy"):
        assert tstats[key] == jstats[key], key
    teng.kv.check_conservation()
    assert teng.kv.pages_live == teng.kv._index_pages
    _margin_rule(tlog, jlog)
    assert teng.outputs == jeng.outputs


def test_paged_engine_serves_the_unpaged_tokens(small, trace_requests):
    """bf16 paging with and without prefix reuse gives the unpaged
    engine's tokens (the trace's hits prefill only their suffix)."""
    _, tcfg, _, tp = small
    reqs = _port(trace_requests)
    base = ServeEngine(tcfg, tp, max_batch=4, cache_len=64,
                       device="cpu").run(reqs)
    for reuse in (True, False):
        eng = ServeEngine(tcfg, tp, max_batch=4, cache_len=64,
                          kv_page_size=8, prefix_reuse=reuse, device="cpu")
        assert eng.run(reqs) == base
        st = eng.last_stats["kvcache"]
        assert (st["prefix_hits"] > 0) == reuse
        eng.kv.check_conservation()


def test_prefill_continue_matches_jax(small):
    """A 21-token prompt whose first 16 lines sit in slot 1 (from a cold
    prefill): the suffix prefill's logits, rows and pos against JAX's."""
    jcfg, tcfg, jp, tp = small
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 128, 21).astype(np.int32)
    start, n, pad = 16, 5, 8
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jc = jm.init_cache(2, 64)
    jc["pos"] = jnp.zeros((2,), jnp.int32)
    tc = tm.init_cache(2, 64, device="cpu")
    tc["pos"] = torch.zeros((2,), dtype=torch.int32)
    head = np.zeros((1, 16), np.int32)
    head[0] = prompt[:start]
    _, jc = jm.prefill_into_slot(jp, jc, np.int32(1),
                                 {"tokens": jnp.asarray(head)}, np.int32(16))
    for name in ("k", "v"):      # the restored lines, as the pages hold them
        tc[name].copy_(torch.from_numpy(
            np.array(jc[name].astype(jnp.float32))).to(torch.bfloat16))
    toks = np.zeros((1, pad), np.int32)
    toks[0, :n] = prompt[start:]
    jl, jc2 = jm.prefill_continue(jp, jc, np.int32(1),
                                  {"tokens": jnp.asarray(toks)},
                                  np.int32(start), np.int32(n))
    tl, tc2 = tm.prefill_continue(tp, tc, 1,
                                  {"tokens": torch.from_numpy(toks).long()},
                                  start, n)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl),
                               atol=SERVE_TOL, rtol=0)
    assert tc2["pos"].tolist() == np.asarray(jc2["pos"]).tolist() == [0, 21]
    for name in ("k", "v"):
        want = np.asarray(jc2[name].astype(jnp.float32))[:, 1, :start + pad]
        got = tc2[name][:, 1, :start + pad].float().numpy()
        scale = np.maximum(np.abs(want[0]), np.abs(want[0]).max() * 1e-2)
        assert float((np.abs(got[0] - want[0]) / scale).max()) * 2 ** 7 <= 1.0
        assert np.abs(got - want).max() <= SERVE_TOL * np.abs(want).max()
    # the continued logits agree with a cold prefill of the whole prompt
    full = torch.from_numpy(prompt[None].astype(np.int64))
    cold, _ = tm.prefill(tp, {"tokens": full})
    np.testing.assert_allclose(tl.float().numpy(), cold.float().numpy(),
                               atol=SERVE_TOL, rtol=0)


def test_hybrid_falls_through_to_the_unpaged_path():
    cfg = reduce_config(get_config("hymba-1.5b"), layers=2, d_model=64,
                        vocab=128)
    assert build_model(cfg).prefill_continue is None
    params = build_model(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 128, 24)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [shared, rng.integers(0, 128, 3 + i)]), max_new_tokens=4)
        for i in range(3)]
    base = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                       device="cpu").run(reqs)
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64,
                      kv_page_size=8, device="cpu")
    assert eng.run(reqs) == base
    kv = eng.last_stats["kvcache"]
    assert not eng.kv.pageable and kv["pages_allocated"] == 0
    assert kv["prefix_lookups"] == 0


def test_mesh_with_paging_raises(small):
    _, tcfg, _, tp = small
    with pytest.raises(ValueError, match="paged K/V cache"):
        ServeEngine(tcfg, tp, max_batch=2, cache_len=64, kv_page_size=8,
                    mesh=object(), device="cpu")


def test_flash_cold_prefill_and_chunked_suffix(small, monkeypatch):
    """With flash on, a cold admission at the 256 bucket runs the flash
    route and a prefix hit's suffix prefill does not (chunked attention
    over the row, as in the JAX package); tokens match the unpaged flash
    engine."""
    _, tcfg, _, tp = small
    cfg = dataclasses.replace(tcfg, use_flash_attention=True)
    from repro_torch.models import attention
    calls = []
    real = attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append(q.shape[1])
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    rng = np.random.default_rng(6)
    system = rng.integers(0, 128, 160)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [system, rng.integers(0, 128, 40 + 10 * i)]), max_new_tokens=3)
        for i in range(3)]
    base = ServeEngine(cfg, tp, max_batch=1, cache_len=272,
                       device="cpu").run(reqs)
    calls.clear()
    eng = ServeEngine(cfg, tp, max_batch=1, cache_len=272, kv_page_size=16,
                      device="cpu")
    out = eng.run(reqs)
    assert eng.last_stats["kvcache"]["prefix_hits"] == 2
    assert calls == [256] * cfg.n_layers          # the cold admission only
    assert out == base
