"""The port's fleet layer against the JAX package's: the trace generator
(`serve/trace.py`, numpy: identical traces for each config and seed),
`dist.fault.backoff_ticks`, `FaultPlan`, `router_slo_summary`, and the
`Router` on the scenarios of tests/test_router_chaos.py and
tests/test_router_overload.py (kills, stalls, flaps, recoveries,
deadlines, shedding with retries, brown-out, paging, and speculative
decoding flapped mid-verify).

Each Router scenario runs the JAX Router with every replica engine's
model calls recorded, and the port's Router with replica i answering its
model calls from JAX replica i's record (tests/_torch_replay.py: each
call's tokens and positions must be the JAX call's). Then the outputs,
the outcome of every request, every tick-denominated statistic and
counter (shed, retry, brown-out, recovery, decode steps, prefills,
kvcache and spec sums) and the per-replica rows must be equal: the
routers' host logic is the same to the tick and the token. The port's
Router is also run on its own model, where its outputs must equal the
port's undisturbed single engine's (tests/test_router_chaos.py's
contract)."""

import dataclasses

import jax
import numpy as np
import pytest

from _prop import given, settings, st
from _torch_replay import Replay
from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.dist import fault as jfault
from repro.models.registry import build_model as jbuild
from repro.serve import router as jrouter
from repro.serve import trace as jtrace
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.dist import fault as tfault
from repro_torch.models import convert
from repro_torch.serve import router as trouter
from repro_torch.serve import trace as ttrace
from repro_torch.serve.engine import ServeEngine

KW = dict(layers=2, d_model=64, vocab=128)
# tests/test_router_chaos.py and tests/test_router_overload.py
TRACE = dict(n_requests=10, arrival="poisson", rate_rps=40.0,
             prompt_median=4, prompt_sigma=0.4, prompt_max=12,
             out_median=6, out_sigma=0.5, out_max=10,
             temperatures=(0.0,), vocab=128, seed=11)
HOT = dict(n_requests=14, arrival="bursty", rate_rps=48.0,
           burst_factor=6.0, burst_every_s=0.25, burst_len_s=0.15,
           prompt_median=4, prompt_sigma=0.4, prompt_max=12,
           out_median=8, out_sigma=0.5, out_max=16,
           temperatures=(0.0,), vocab=128, seed=7)


@pytest.fixture(scope="module")
def small():
    jcfg = jreduce(jget("qwen2-1.5b"), **KW)
    tcfg = reduce_config(get_config("qwen2-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def draft():
    """tests/test_router_chaos.py's spec draft: one layer, seed 1."""
    jcfg = jreduce(jget("qwen2-1.5b"), layers=1, d_model=64, vocab=128)
    tcfg = reduce_config(get_config("qwen2-1.5b"), layers=1, d_model=64,
                         vocab=128)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(1))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------------ trace

def _same_trace(a, b):
    assert a.burst_windows == b.burst_windows
    assert len(a.requests) == len(b.requests)
    for x, y in zip(a.requests, b.requests):
        assert x.t_arrival == y.t_arrival
        assert x.deadline_ticks == y.deadline_ticks
        assert x.request.rid == y.request.rid
        assert x.request.max_new_tokens == y.request.max_new_tokens
        assert x.request.temperature == y.request.temperature
        assert x.request.prompt.dtype == y.request.prompt.dtype == np.int32
        np.testing.assert_array_equal(x.request.prompt, y.request.prompt)
    for tick_s in (0.05, 0.01):
        assert a.arrival_ticks(tick_s) == b.arrival_ticks(tick_s)
        assert a.burst_ticks(tick_s, 500) == b.burst_ticks(tick_s, 500)
    assert a.max_request_len() == b.max_request_len()


def _props_cfg(mod, seed, arrival):
    """tests/test_router_props.py's _cfg."""
    return mod.TraceConfig(n_requests=12, arrival=arrival, rate_rps=20.0,
                           burst_every_s=0.3, burst_len_s=0.1,
                           prompt_median=4, prompt_sigma=0.5, prompt_max=10,
                           out_median=4, out_sigma=0.6, out_max=8,
                           temperatures=(0.0, 0.7), vocab=64, seed=seed)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=1 << 16),
       arrival=st.sampled_from(["poisson", "bursty"]))
def test_trace_equals_jax_props_configs(seed, arrival):
    _same_trace(ttrace.generate_trace(_props_cfg(ttrace, seed, arrival)),
                jtrace.generate_trace(_props_cfg(jtrace, seed, arrival)))


@pytest.mark.parametrize("extra", [
    {}, {"deadline_median": 8, "deadline_sigma": 0.8, "deadline_max": 40},
    {"shared_prefix_frac": 0.8, "prefix_pool": 2, "prefix_len": 16},
    {"n_requests": 16, "prompt_median": 128, "prompt_max": 256,
     "out_median": 16, "out_max": 24, "vocab": 151936, "seed": 0}])
@pytest.mark.parametrize("base", [TRACE, HOT])
def test_trace_equals_jax_scenarios(base, extra):
    """The chaos and overload traces, with deadlines, shared prefixes and
    chip_smoke.py's phase-13 trace."""
    kw = {**base, **extra}
    t = ttrace.generate_trace(ttrace.TraceConfig(**kw))
    _same_trace(t, jtrace.generate_trace(jtrace.TraceConfig(**kw)))
    assert [r.request.rid for r in t.requests] == list(range(kw["n_requests"]))


def test_trace_rejects_unknown_arrival():
    with pytest.raises(ValueError, match="unknown arrival"):
        ttrace.generate_trace(ttrace.TraceConfig(arrival="flash-crowd"))


# ---------------------------------------------------- fault plan, backoff

@pytest.mark.parametrize("base,cap", [(1, 32), (2, 12), (0, 5), (3, 0)])
def test_backoff_ticks_equals_jax(base, cap):
    for attempt in range(1, 12):
        assert tfault.backoff_ticks(attempt, base=base, cap=cap) \
            == jfault.backoff_ticks(attempt, base=base, cap=cap)
    for bad in (dict(attempt=0), dict(attempt=1, base=-1)):
        with pytest.raises(ValueError):
            tfault.backoff_ticks(bad.pop("attempt"), **bad)


def _rows(events):
    return [(e.tick, e.replica, e.kind, e.duration, e.seq) for e in events]


def test_fault_plan_equals_jax():
    def build(mod):
        p = mod.FaultPlan([mod.FaultEvent(tick=3, replica=1, kind="stall",
                                          duration=2),
                           mod.FaultEvent(tick=3, replica=0, kind="kill")])
        p.kill(0, at_tick=5).recover(0, at_tick=5)
        p.flap(1, at_tick=6, down_ticks=4, times=2)
        return p
    t, j = build(trouter), build(jrouter)
    assert _rows(t.events) == _rows(j.events)
    for tick in range(20):
        assert _rows(t.events_at(tick)) == _rows(j.events_at(tick))
        assert t.has_recovery_after(tick) == j.has_recovery_after(tick)
    with pytest.raises(ValueError):
        trouter.FaultPlan().flap(0, at_tick=0, down_ticks=0)
    with pytest.raises(ValueError):
        trouter.FaultPlan().flap(0, at_tick=0, down_ticks=4, times=2,
                                 period=3)


def test_router_slo_summary_equals_jax():
    samples = ([3, 1, 4, 1, 5], [0.5, 2.0, 1.25], [0.1, 0.3], [0.01],
               [0, 2, 2, 7])
    assert trouter.router_slo_summary(*samples) \
        == jrouter.router_slo_summary(*samples)
    assert trouter.router_slo_summary([], [], [], [], []) \
        == jrouter.router_slo_summary([], [], [], [], [])


# ------------------------------------------------------------------ router

FLAP = ("flap", 1, dict(at_tick=3, down_ticks=4))
# (name, trace config, Router keywords, fault plan calls); every scenario
# of tests/test_router_chaos.py and tests/test_router_overload.py
SCENARIOS = [
    ("kill-mid-decode", TRACE, dict(stale_after_ticks=2),
     [("kill", 1, dict(at_tick=3))]),
    ("long-stall", TRACE, dict(stale_after_ticks=2),
     [("stall", 0, dict(at_tick=2, ticks=8))]),
    ("short-stall", TRACE, dict(stale_after_ticks=4),
     [("stall", 1, dict(at_tick=2, ticks=2))]),
    ("paged-flap", TRACE, dict(stale_after_ticks=2, kv_page_size=8), [FLAP]),
    ("spec-paged-flap", TRACE,
     dict(stale_after_ticks=2, kv_page_size=8, spec_k=2), [FLAP]),
    ("deadlines", {**HOT, "deadline_median": 8, "deadline_sigma": 0.8,
                   "deadline_max": 40}, {}, []),
    ("bounded-queue-retry", HOT, dict(max_queue=2, retry_budget=1), []),
    ("retry-budget-zero", HOT, dict(max_queue=0, retry_budget=0), []),
    ("reject-newest", HOT, dict(max_queue=1, retry_budget=0), []),
    ("reject-oldest", HOT, dict(max_queue=1, retry_budget=0,
                                shed_policy="reject-oldest"), []),
    ("brownout", HOT, dict(retry_budget=0, overload="ov"), []),
    ("recover-rejoins", TRACE, dict(stale_after_ticks=2),
     [("kill", 1, dict(at_tick=3)), ("recover", 1, dict(at_tick=8))]),
    ("repeated-flap", TRACE, dict(stale_after_ticks=2),
     [("flap", 1, dict(at_tick=3, down_ticks=5, times=2))]),
    ("all-dead-waits", TRACE, dict(stale_after_ticks=1),
     [("kill", 0, dict(at_tick=1)), ("kill", 1, dict(at_tick=1)),
      ("recover", 0, dict(at_tick=6))]),
    ("burst-flap-acceptance", {**HOT, "deadline_median": 20,
                               "deadline_sigma": 0.8, "deadline_max": 80},
     dict(stale_after_ticks=2, max_queue=3, retry_budget=1),
     [("flap", 1, dict(at_tick=4, down_ticks=4, times=2))]),
]

# stats read off the wall clock (and the straggler watchdog, which
# observes wall-clock step times) — everything else must be equal
WALL_KEYS = {"wall_s", "goodput_tok_per_s", "p50_ttft_s", "p99_ttft_s",
             "p50_tpot_s", "p99_tpot_s", "straggler_events"}


def _routers(mod, small, draft, tmp_path, trace_kw, kw, plan_calls, tag):
    jcfg, tcfg, jp, tp = small
    port = mod is trouter
    plan = mod.FaultPlan()
    for fn, rep, args in plan_calls:
        getattr(plan, fn)(rep, **args)
    kw = dict(kw)
    if kw.get("overload") == "ov":
        kw["overload"] = mod.OverloadConfig(window_ticks=2, queue_high=1,
                                            queue_low=0)
    if kw.get("spec_k"):
        kw["draft_cfg"] = draft[1] if port else draft[0]
        kw["draft_params"] = draft[3] if port else draft[2]
    if port:
        kw["device"] = "cpu"
    return mod.Router(tcfg if port else jcfg, tp if port else jp,
                      replicas=2, max_batch=2, cache_len=64, rng_seed=0,
                      heartbeat_dir=str(tmp_path / tag), fault_plan=plan,
                      **kw)


@pytest.mark.parametrize("name,trace_kw,kw,plan_calls", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_router_equals_jax(small, draft, tmp_path, name, trace_kw, kw,
                           plan_calls):
    jr = _routers(jrouter, small, draft, tmp_path, trace_kw, kw, plan_calls,
                  "jax")
    tr = _routers(trouter, small, draft, tmp_path, trace_kw, kw, plan_calls,
                  "port")
    replays = [Replay() for _ in jr.replicas]
    for rec, rep in zip(replays, jr.replicas):
        rec.record(rep.engine)
    jout, jst = jr.run(jtrace.generate_trace(jtrace.TraceConfig(**trace_kw)))
    for rec, rep in zip(replays, tr.replicas):
        rec.replay(rep.engine)
    tout, tst = tr.run(ttrace.generate_trace(ttrace.TraceConfig(**trace_kw)))
    for rec in replays:
        rec.check_all_used()
    assert tout == jout
    assert tst["outcomes"] == jst["outcomes"]
    assert set(tst) == set(jst)
    for key in set(jst) - WALL_KEYS - {"per_replica"}:
        assert tst[key] == jst[key], key
    for trow, jrow in zip(tst["per_replica"], jst["per_replica"]):
        assert {k: v for k, v in trow.items() if k not in WALL_KEYS} \
            == {k: v for k, v in jrow.items() if k not in WALL_KEYS}
    assert sorted(tst["outcomes"]) == list(range(trace_kw["n_requests"]))
    assert tst["completed"] + tst["shed"] + tst["deadline_missed"] \
        == trace_kw["n_requests"]
    if kw.get("kv_page_size"):
        for rep in tr.replicas:
            rep.engine.kv.check_conservation()
            assert rep.engine.kv.pages_live == rep.engine.kv._index_pages
    if kw.get("spec_k"):
        sp = tst["spec"]
        assert sp["accepted"] + sp["rejected"] + sp["bonus"] \
            == sp["tokens_emitted"] > 0


@pytest.mark.parametrize("router", ["jax", "port"])
def test_all_replicas_dead_raises(small, draft, tmp_path, router):
    mod = trouter if router == "port" else jrouter
    tmod = ttrace if router == "port" else jtrace
    rt = _routers(mod, small, draft, tmp_path, TRACE,
                  dict(stale_after_ticks=1),
                  [("kill", 0, dict(at_tick=1)), ("kill", 1, dict(at_tick=1))],
                  router)
    with pytest.raises(RuntimeError, match="dead/fenced"):
        rt.run(tmod.generate_trace(tmod.TraceConfig(**TRACE)))


def test_router_argument_refusals(small):
    _, tcfg, _, tp = small
    with pytest.raises(ValueError, match="shed_policy"):
        trouter.Router(None, None, shed_policy="drop-random")
    with pytest.raises(ValueError, match="replica"):
        trouter.Router(tcfg, tp, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="'model' axis"):
        trouter.Router(tcfg, tp, mesh=object(), device="cpu")


# ------------------------------------------------ the port on its own model

@pytest.fixture(scope="module")
def port_baseline(small):
    """The undisturbed single-engine run of TRACE on the port's model."""
    _, tcfg, _, tp = small
    trace = ttrace.generate_trace(ttrace.TraceConfig(**TRACE))
    return trace, ServeEngine(tcfg, tp, max_batch=4, cache_len=64,
                              device="cpu").run(trace.plain_requests())


@pytest.mark.parametrize("name,kw,plan_calls", [
    ("kill-mid-decode", dict(stale_after_ticks=2),
     [("kill", 1, dict(at_tick=3))]),
    ("spec-paged-flap", dict(stale_after_ticks=2, kv_page_size=8, spec_k=2),
     [FLAP])])
def test_router_on_its_own_model_equals_single_engine(
        small, draft, port_baseline, tmp_path, name, kw, plan_calls):
    """tests/test_router_chaos.py:58 and :185 on the port's own model: the
    fleet's outputs are the undisturbed engine's, token for token, and two
    runs give identical tick statistics."""
    trace, base = port_baseline
    runs = []
    for i in range(2):
        rt = _routers(trouter, small, draft, tmp_path, TRACE, kw, plan_calls,
                      f"own{i}")
        runs.append(rt.run(trace))
    (out_a, st_a), (out_b, st_b) = runs
    assert out_a == base == out_b
    assert st_a["requeued"] > 0 and st_a["wasted_toks"] > 0
    for key in set(st_a) - WALL_KEYS - {"per_replica"}:
        assert st_a[key] == st_b[key], key
    if kw.get("kv_page_size"):
        for rep in rt.replicas:
            rep.engine.kv.check_conservation()


def test_replicas_share_one_params_tree(small, draft, tmp_path):
    _, tcfg, _, tp = small
    rt = trouter.Router(tcfg, tp, replicas=3, max_batch=2, cache_len=64,
                        device="cpu", heartbeat_dir=str(tmp_path / "share"),
                        draft_cfg=draft[1], draft_params=draft[3], spec_k=2)
    a, b, c = (r.engine for r in rt.replicas)
    for leaf in ("embed", "final_norm"):
        assert a.params[leaf] is b.params[leaf] is c.params[leaf] \
            is tp[leaf]
    assert a.draft_params["embed"] is c.draft_params["embed"]


def test_router_defaults_to_the_card(small, monkeypatch):
    import torch
    _, tcfg, _, tp = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trouter.Router(tcfg, tp)


def test_dataclass_defaults_equal_jax():
    for name in ("TraceConfig",):
        t = dataclasses.asdict(getattr(ttrace, name)())
        j = dataclasses.asdict(getattr(jtrace, name)())
        assert t == j
    assert dataclasses.asdict(trouter.OverloadConfig()) \
        == dataclasses.asdict(jrouter.OverloadConfig())
