"""The port's vlm family (internvl2) against the JAX package's, on the same
weights (the JAX params carried across with convert.params_from_numpy)
and the same numpy inputs, at the reduced internvl2-26b (2 layers,
d_model 64, two heads of 32, vocab 128, n_vis_tokens 8): prefill logits
and cache with f32 and bf16 patch embeddings (cast to bf16 and prepended
in both); decode steps at a shared and at per-row positions, and
prefill_into_slot, whose prompt_len counts the vis lines; loss_fn on the
text positions only, and every gradient; the engine against the JAX
engine; the port of the reference's
test_vlm_bucket_accounts_for_vis_tokens; and one prefill at S = 256 (248
text + 8 vis) with flash on, where the JAX side runs its Pallas kernel in
interpret mode and the port the kernel's plain version.

The JAX side is compiled with xla_allow_excess_precision off (`_strict`)
where it can be (the Pallas route runs as the JAX package's own tests
run it). Tolerances as tests/test_torch_model.py: logits within
LOGIT_ATOL = 2e-2 (measured: 3e-8 strict, the dense stack's products and
norms rounding alike; 1.1e-3 with flash, JAX's Pallas kernel against the
plain version, and 1.0e-3 between the port's flash and chunked routes),
k/v within KV_ULPS = 4 bf16 ulps of the largest line; the loss within
LOSS_ATOL = 1e-3 and every gradient leaf within GRAD_RTOL = 3e-2 of its
max |JAX grad|; greedy engine tokens as tests/test_torch_encdec.py
(SERVE_TOL = 1e-2, up to each request's first near tie)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models.registry import build_model as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import convert
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.serve.engine import Request, ServeEngine

from _torch_replay import (Replay, greedy_up_to_near_ties,
                           record_sampled_logits)

LOGIT_ATOL = 2e-2
KV_ULPS = 4 * 2.0 ** -7
LOSS_ATOL = 1e-3
GRAD_RTOL = 3e-2
SERVE_TOL = 1e-2
KW = dict(layers=2, d_model=64, vocab=128)
N_VIS = 8


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("internvl2-26b"), **KW)
    tcfg = reduce_config(get_config("internvl2-26b"), **KW)
    assert jcfg.n_vis_tokens == tcfg.n_vis_tokens == N_VIS
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


def _strict(fn, *args):
    """fn(*args) jitted with xla_allow_excess_precision off."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)


def _vis(b, dtype="f32", seed=0):
    v = np.random.default_rng(200 + seed).standard_normal(
        (b, N_VIS, 64)).astype(np.float32)
    return v if dtype == "f32" else v.astype(jnp.bfloat16)


def _port(batch):
    return {k: convert.tensor_from_numpy(v, "cpu") for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL,
                               rtol=0)


def _cache_close(tc, jc):
    assert set(tc) == set(jc) == {"k", "v", "pos"}
    for key in ("k", "v"):
        t, j = tc[key].float().numpy(), np.asarray(jc[key], np.float32)
        assert t.shape == j.shape and tc[key].dtype == torch.bfloat16, key
        assert np.max(np.abs(t - j)) <= KV_ULPS * np.max(np.abs(j)), key
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("vis", ["f32", "bf16"])
def test_prefill_logits_and_cache(weights, vis):
    """The vis prefix counts in the cache: S = 8 + 13 lines, pos 21; the
    param tree is the dense one; init_cache is JAX's make_cache."""
    jcfg, tcfg, jp, tp = weights
    batch = {"tokens": _tokens((2, 13), seed=1), "vis": _vis(2, vis)}
    jl, jc = _strict(jbuild(jcfg).prefill, jp, _jax(batch))
    tl, tc = build_model(tcfg).prefill(tp, _port(batch))
    assert tl.shape == (2, 1, 128) and tl.dtype == torch.float32
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == N_VIS + 13
    assert set(_flat(tp)) == set(_flat(jax.tree.map(np.asarray, jp)))
    jc0 = jbuild(jcfg).init_cache(3, 48)
    tc0 = build_model(tcfg).init_cache(3, 48, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc0.items()} == \
        {k: tuple(v.shape) for k, v in jc0.items()}


def test_decode_steps_and_slot_prefill_match_jax(weights):
    """A shared-pos decode: prefill (8 vis + 12 text) copied into a 32-line
    cache, four steps against JAX, the first against a prefill of 13 text
    tokens (0.05 relative). Then prefill_into_slot into rows 0 and 2 of a
    3-row cache, text right-padded to 16 and prompt_len counting the vis
    lines, and three per-row decode steps."""
    jcfg, tcfg, jp, tp = weights
    jm, tm = jbuild(jcfg), build_model(tcfg)
    toks = _tokens((2, 13), seed=2)
    vis = _vis(2, "bf16", seed=2)
    _, jc = _strict(jm.prefill, jp, _jax({"tokens": toks[:, :12],
                                          "vis": vis}))
    for key in ("k", "v"):
        jc[key] = jnp.pad(jc[key], [(0, 0), (0, 0), (0, 12), (0, 0),
                                    (0, 0)])
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    feed = toks[:, 12:]
    for step in range(4):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        if step == 0:
            full, _ = tm.prefill(tp, _port({"tokens": toks, "vis": vis}))
            err = float((tl - full).abs().max())
            assert err / float(full.abs().max()) < 0.05
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)

    jc = jm.init_cache(3, 40)
    jc["pos"] = jnp.zeros((3,), jnp.int32)
    tc = tm.init_cache(3, 40, device="cpu")
    tc["pos"] = torch.zeros((3,), dtype=torch.int32)
    for slot, n in ((0, 11), (2, 5)):
        t = np.zeros((1, 16), np.int32)
        t[0, :n] = _tokens((n,), seed=20 + slot)
        batch = {"tokens": t, "vis": _vis(1, "f32", seed=slot)}
        jl, jc = _strict(jm.prefill_into_slot, jp, jc, slot, _jax(batch),
                         N_VIS + n)
        tl, tc = tm.prefill_into_slot(tp, tc, slot, _port(batch), N_VIS + n)
        _logits_close(tl, jl)
    assert tc["pos"].tolist() == [N_VIS + 11, 0, N_VIS + 5]
    assert not tc["k"][:, 1].any()
    feed = _tokens((3, 1), seed=5)
    for _ in range(3):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)


def test_loss_on_text_positions_and_grads_match_jax(weights):
    """loss_fn with 8 vis + 32 text positions and labels over the text
    only (partly masked): the loss, ntokens (text alone) and every
    gradient leaf; the vis rows' hidden states reach no label."""
    jcfg, tcfg, jp, _ = weights
    toks = _tokens((2, 33), seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
             "vis": _vis(2, "f32", seed=3)}
    batch["labels"][1, -4:] = -1
    (_, jmet), jg = _strict(
        jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True), jp,
        _jax(batch))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, met = build_model(tcfg).loss_fn(params, _port(batch))
    grads = _flat(tree_unflatten(params, torch.autograd.grad(total,
                                                             leaves)))
    assert abs(float(met["loss"].detach()) - float(jmet["loss"])) <= LOSS_ATOL
    assert float(met["ntokens"]) == float(jmet["ntokens"]) == 2 * 32 - 4
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for path, j in jflat.items():
        j = np.asarray(j, np.float32)
        t = grads[path].float().numpy()
        assert np.isfinite(t).all(), path
        err = float(np.max(np.abs(t - j)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(j))), (path, err)


SPECS = [(0, 5, 4), (1, 12, 6), (2, 9, 3), (3, 20, 5)]


def _engine_requests(cls, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, prompt=rng.integers(0, 128, n).astype(np.int32),
                max_new_tokens=m, extra={"vis": _vis(1, "bf16", seed=r)})
            for r, n, m in SPECS]


def test_engine_matches_jax_engine(weights, monkeypatch):
    """The port engine against the JAX engine (vis in Request.extra, text
    bucketed to 8, 16 and 32 under the room cache_len - 8): the same
    schedule and prompt lengths (vis counted); greedy tokens equal up to
    each request's first near tie, logits within SERVE_TOL; a port engine
    on the JAX engine's replayed model outputs asks for the same calls
    and emits its tokens exactly; paged (k/v over vis + text lines, no
    prefix reuse) = unpaged."""
    jcfg, tcfg, jp, tp = weights
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=48)
    teng = ServeEngine(tcfg, tp, max_batch=2, cache_len=48, device="cpu")
    jlog, tlog = {}, {}
    record_sampled_logits(monkeypatch, jeng, jlog)
    record_sampled_logits(monkeypatch, teng, tlog)
    rec = Replay()
    rec.record(jeng)
    jout = jeng.run(_engine_requests(JRequest))
    tout = teng.run(_engine_requests(Request))
    assert greedy_up_to_near_ties(jlog, tlog, jout, tout, SERVE_TOL) \
        >= len(SPECS)
    for key in ("decode_steps", "prefills", "new_tokens"):
        assert teng.last_stats[key] == jeng.last_stats[key], key
    assert ({r: s.prompt_len for r, s in teng.request_stats.items()}
            == {r: s.prompt_len for r, s in jeng.request_stats.items()}
            == {r: N_VIS + n for r, n, _ in SPECS})
    replayed = ServeEngine(tcfg, tp, max_batch=2, cache_len=48, device="cpu")
    rec.replay(replayed)
    assert replayed.run(_engine_requests(Request)) == jout
    rec.check_all_used()
    assert [c[0].shape[1] for c in rec.calls["prefill"]] == [8, 16, 16, 32]
    paged = ServeEngine(tcfg, tp, max_batch=2, cache_len=48, kv_page_size=8,
                        device="cpu")
    assert paged.run(_engine_requests(Request)) == tout
    assert paged.kv.pageable and not paged.kv.prefix_reuse
    assert paged.kv.pages_live == 0


def test_vlm_bucket_accounts_for_vis_tokens(weights):
    """The port of the reference's regression test (tests/test_serve.py:
    216): a prompt near cache_len is not bucketed past the room left after
    the vis lines (50 text -> 50, not 64, in a 64-line slot with 8 vis);
    a prompt that no longer fits raises."""
    _, tcfg, _, tp = weights
    eng = ServeEngine(tcfg, tp, max_batch=1, cache_len=64, device="cpu")
    assert eng._bucket_len(50, 64 - N_VIS) == 50
    prompt = np.arange(50, dtype=np.int32) % 128   # 50 + 8 vis + 5 new <= 64
    vis = torch.zeros((1, N_VIS, 64), dtype=torch.bfloat16)
    out = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=5,
                           extra={"vis": vis})])
    assert len(out[0]) == 5
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.run([Request(rid=1, prompt=prompt, max_new_tokens=7,
                         extra={"vis": vis})])


def test_flash_prefill_at_s256(weights):
    """use_flash_attention with 248 text + 8 vis tokens: S = 256 takes the
    flash route in both (JAX's Pallas kernel in interpret mode, the port's
    plain version on the CPU); logits and k/v against JAX's, and the
    port's flash route within LOGIT_ATOL of its own chunked one. A
    pad_lens batch is refused (the vis prefix)."""
    jcfg, tcfg, jp, tp = weights
    jm = jbuild(dataclasses.replace(jcfg, use_flash_attention=True))
    tm = build_model(dataclasses.replace(tcfg, use_flash_attention=True))
    batch = {"tokens": _tokens((1, 248), seed=4), "vis": _vis(1, "bf16", 4)}
    jl, jc = jm.prefill(jp, _jax(batch))
    tl, tc = tm.prefill(tp, _port(batch))
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == 256
    chunked, _ = build_model(tcfg).prefill(tp, _port(batch))
    _logits_close(tl, chunked)
    with pytest.raises(ValueError, match="vis"):
        tm.prefill(tp, dict(_port(batch), pad_lens=torch.tensor([2])))
