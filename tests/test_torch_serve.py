"""The port's ServeEngine against the JAX package's on the same weights
and requests: the schedule (every StepReport of a stepwise run and the
stats counters) must match exactly — it is host logic; greedy tokens
must match over short runs, with flash attention off and on; plus the
port-only contracts (sampling determinism, max_new_tokens 0 and 1, the
options that are not ported, the card default).

Greedy tokens: at every compared step the JAX and port logits agree
within SERVE_TOL = 1e-2 (bf16 activations, measured ~2e-3 at this size;
see tests/test_torch_model.py) and the test asserts that the top-2 logit
margin exceeds SERVE_TOL, so the argmax cannot flip between the two: a
near-tie fails loudly instead of at random."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import convert
from repro_torch.serve.engine import Request, ServeEngine

from _torch_replay import record_sampled_logits

SERVE_TOL = 1e-2
KW = dict(layers=2, d_model=64, vocab=128)


@pytest.fixture(scope="module")
def small():
    jcfg = jreduce(jget("qwen2-1.5b"), **KW)
    tcfg = reduce_config(get_config("qwen2-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


def _requests(specs, seed=0):
    """specs: (rid, prompt_len, max_new_tokens); prompts from a seed."""
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, 128, plen).astype(np.int32), n)
            for rid, plen, n in specs]


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


COUNTERS = ("requests", "decode_steps", "prefills", "new_tokens",
            "occupancy")


@pytest.mark.parametrize("flash", [False, True])
def test_schedule_stats_and_greedy_tokens_match_jax(small, monkeypatch, flash):
    jcfg, tcfg, jp, tp = small
    jcfg = dataclasses.replace(jcfg, use_flash_attention=flash)
    tcfg = dataclasses.replace(tcfg, use_flash_attention=flash)
    if flash:      # prompts of 129-256 tokens pad to the 256 bucket
        specs = [(0, 200, 4), (1, 150, 6), (2, 240, 3)]
    else:          # mixed lengths and budgets, more requests than slots
        specs = [(0, 5, 4), (1, 9, 7), (2, 3, 1), (3, 17, 5), (4, 6, 0),
                 (5, 12, 6)]
    reqs = _requests(specs, seed=1 + flash)
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=272)
    teng = ServeEngine(tcfg, tp, max_batch=2, cache_len=272, device="cpu")
    jlog, tlog = {}, {}
    record_sampled_logits(monkeypatch, jeng, jlog)
    record_sampled_logits(monkeypatch, teng, tlog)
    jrep, jstats = _stepwise(jeng, [JRequest(rid=r, prompt=p,
                                             max_new_tokens=n)
                                    for r, p, n in reqs])
    trep, tstats = _stepwise(teng, [Request(rid=r, prompt=p, max_new_tokens=n)
                                    for r, p, n in reqs])
    assert trep == jrep
    for key in COUNTERS:
        assert tstats[key] == jstats[key], key
    for rid, st in jeng.request_stats.items():
        mine = teng.request_stats[rid]
        assert (mine.prompt_len, mine.new_tokens, mine.decode_steps) == \
            (st.prompt_len, st.new_tokens, st.decode_steps)
    assert set(tlog) == set(jlog)
    for k, want in jlog.items():
        np.testing.assert_allclose(tlog[k], want, atol=SERVE_TOL, rtol=0)
        top2 = np.sort(want)[-2:]
        assert top2[1] - top2[0] > SERVE_TOL, (k, top2)
    assert teng.outputs == jeng.outputs


@pytest.fixture(scope="module")
def port_small(small):
    return small[1], small[3]


def test_temperature_sampling_is_deterministic_and_independent(port_small):
    """A sampled request's tokens do not depend on slot placement,
    batch-mates or admission order (tests/test_serve.py:83 for the port;
    the stream is JAX's, held in tests/test_torch_spec.py)."""
    cfg, params = port_small

    def tgt():
        return Request(rid=5, prompt=(np.arange(6) * 3) % 128,
                       max_new_tokens=8, temperature=0.7)

    mates = [Request(rid=1, prompt=np.arange(3) % 128, max_new_tokens=2),
             Request(rid=2, prompt=np.arange(9) % 128, max_new_tokens=20,
                     temperature=1.1)]

    def eng(b):
        return ServeEngine(cfg, params, max_batch=b, cache_len=64,
                           rng_seed=1, device="cpu")

    a = eng(3).run([tgt()] + mates)
    b = eng(3).run(mates + [tgt()])
    c = eng(1).run([tgt()])
    assert a[5] == b[5] == c[5]
    d = eng(2).run([tgt(), Request(rid=6, prompt=(np.arange(6) * 3) % 128,
                                   max_new_tokens=8, temperature=0.7)])
    assert d[5] != d[6]
    other = ServeEngine(cfg, params, max_batch=1, cache_len=64, rng_seed=2,
                        device="cpu").run([tgt()])
    assert other[5] != c[5]


def test_max_new_tokens_one_and_zero(port_small):
    cfg, params = port_small
    reqs = [Request(rid=0, prompt=np.arange(4) % 128, max_new_tokens=1),
            Request(rid=1, prompt=np.arange(5) % 128, max_new_tokens=3),
            Request(rid=2, prompt=np.arange(4) % 128, max_new_tokens=0)]
    out, stats = ServeEngine(cfg, params, max_batch=1, cache_len=64,
                             device="cpu").run(reqs, collect_stats=True)
    assert len(out[0]) == 1 and len(out[1]) == 3 and out[2] == []
    assert stats["requests"][0].decode_steps == 0
    assert stats["requests"][2].new_tokens == 0
    e = stats["engine"]
    assert e["requests"] == 3 and e["prefills"] == 2
    assert e["new_tokens"] == 4 and e["tok_per_s"] > 0


def test_request_larger_than_the_cache_raises(port_small):
    cfg, params = port_small
    eng = ServeEngine(cfg, params, max_batch=1, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        eng.run([Request(rid=0, prompt=np.arange(10), max_new_tokens=7)])


@pytest.mark.parametrize("kwargs", [{"mesh": object()}])
def test_unported_options_raise(port_small, kwargs):
    """mesh= is ported for the dense family (tests/test_torch_serve_tp.py);
    what it is given must be a mesh with a "model" axis."""
    cfg, params = port_small
    with pytest.raises(ValueError, match="'model' axis"):
        ServeEngine(cfg, params, device="cpu", **kwargs)


def test_engine_defaults_to_the_card(port_small, monkeypatch):
    cfg, params = port_small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError):
        repro_torch.build_model(cfg).init_params(0)


def test_other_families_raise():
    """Every family of FAMILIES builds (at reduce_config, one config each:
    params, a prefill of 8 tokens with its frames or vis, finite logits),
    and mesh= takes only a mesh with a "model" axis."""
    from repro_torch.configs.base import ARCH_IDS, FAMILIES
    built = set()
    for arch in ARCH_IDS:
        cfg = reduce_config(get_config(arch), layers=1, d_model=64, vocab=128)
        if cfg.family in built:
            continue
        built.add(cfg.family)
        model = repro_torch.build_model(cfg)
        params = model.init_params(0, device="cpu")
        batch = {"tokens": torch.arange(8)[None]}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, cfg.enc_seq, 64))
        if cfg.family == "vlm":
            batch["vis"] = torch.zeros((1, cfg.n_vis_tokens, 64))
        logits, _ = model.prefill(params, batch)
        assert logits.shape == (1, 1, 128), arch
        assert torch.isfinite(logits).all(), arch
    assert built == set(FAMILIES)
    with pytest.raises(ValueError, match="'model' axis"):
        ServeEngine(cfg, params, device="cpu", mesh=object())


@pytest.mark.parametrize("flash", [False, True])
def test_serving_with_trainer_params_records_no_graph(small, flash):
    """Params that require grad (as the trainer leaves them) serve the same
    greedy tokens as plain ones, and prefill, decode_step and
    prefill_into_slot return tensors without a grad_fn: serving runs
    under torch.no_grad, so no graph is recorded and FlashAttention saves
    nothing."""
    _, tcfg, _, tp = small
    cfg = dataclasses.replace(tcfg, use_flash_attention=flash)

    def requiring(node):
        if isinstance(node, dict):
            return {k: requiring(v) for k, v in node.items()}
        return node.detach().clone().requires_grad_(True)

    trained = requiring(tp)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, p, n in _requests([(0, 256, 4), (1, 200, 3)])]
    want = ServeEngine(cfg, tp, max_batch=2, cache_len=272,
                       device="cpu").run(reqs)
    got = ServeEngine(cfg, trained, max_batch=2, cache_len=272,
                      device="cpu").run(reqs)
    assert got == want
    model = repro_torch.build_model(cfg)
    toks = torch.from_numpy(_requests([(0, 256, 1)])[0][1][None].astype(
        np.int64))
    logits, cache = model.prefill(trained, {"tokens": toks})
    assert logits.grad_fn is None and cache["k"].grad_fn is None
    slots = model.init_cache(2, 272, device="cpu")
    slots["pos"] = torch.zeros((2,), dtype=torch.int32)
    logits, slots = model.prefill_into_slot(trained, slots, 1,
                                            {"tokens": toks}, 256)
    assert logits.grad_fn is None and slots["k"].grad_fn is None
    logits, slots = model.decode_step(trained, slots, toks[:, -2:].T)
    assert logits.grad_fn is None and slots["k"].grad_fn is None
