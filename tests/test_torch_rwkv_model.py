"""The port's ssm family (rwkv6) against the JAX package's, on the same
weights (the JAX params carried across with convert.params_from_numpy)
and the same numpy tokens, at the reduced rwkv6-7b (2 layers, d_model 64,
two heads of 32, vocab 128): the param tree and cache layout; prefill
logits and every cache leaf at S = 40 (one chunk), 64 and 128 (64-step
chunks; at 128 the initial decay crosses the -60 clamp) and 70 (the
sequential scan); decode steps and prefill_into_slot with per-row
decode; loss_fn and every gradient at T = 128; then the engine (on the
JAX engine's replayed model outputs, tests/_torch_replay.py, and on its
own: batch-mates undisturbed, paged = unpaged), the refusals (pad_lens,
prefill_continue, decode_verify, spec) and a Trainer that resumes
bit-equal.

The JAX side is compiled with xla_allow_excess_precision off (`_strict`):
XLA otherwise keeps the bf16 token-shift mix in f32 across a fusion,
where the port (eager torch) rounds after each op, and the logits move by
~3e-3. Compiled so, the two agree to within a few f32 ulps where no bf16
rounding flips. Tolerances: logits within LOGIT_ATOL = 5e-3; tm/cm (bf16)
within KV_ULPS = 2 bf16 ulps of the leaf's largest value and wkv (f32)
within WKV_RTOL = 1e-3 of its largest value (one flipped bf16 rounding,
carried a layer); the loss within LOSS_ATOL = 1e-3 and every gradient
leaf within GRAD_RTOL = 3e-2 of its max |JAX grad|, as
tests/test_torch_train.py (the backward sums in another order and rounds
the grads to bf16). Measured: logits 8.7e-4 apart at S = 128, 3e-8 at
the other lengths; gradients within 1.6e-2 for the token-shift mus (each
a sum of signed terms over every token) and 6.2e-3 for every other
leaf."""

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
from repro_torch.train.trainer import TrainLoopConfig, Trainer

from _torch_replay import Replay

LOGIT_ATOL = 5e-3
KV_ULPS = 2 * 2.0 ** -7
WKV_RTOL = 1e-3
LOSS_ATOL = 1e-3
GRAD_RTOL = 3e-2
KW = dict(layers=2, d_model=64, vocab=128)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("rwkv6-7b"), **KW)
    tcfg = reduce_config(get_config("rwkv6-7b"), **KW)
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


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL,
                               rtol=0)


def _cache_close(tc, jc):
    assert set(tc) == set(jc) == {"wkv", "tm", "cm", "pos"}
    for key in ("tm", "cm", "wkv"):
        t, j = tc[key].float().numpy(), np.asarray(jc[key], np.float32)
        assert t.shape == j.shape, key
        tol = WKV_RTOL if key == "wkv" else KV_ULPS
        assert np.max(np.abs(t - j)) <= tol * np.max(np.abs(j)), key
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["wkv"].dtype == torch.float32
    assert tc["tm"].dtype == tc["cm"].dtype == torch.bfloat16


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_param_tree_and_cache_layout(weights):
    """The port builds the JAX tree's paths and shapes, with the constant
    inits (ln1, ln2, ln_x ones) bit for bit; a carried leaf keeps its
    bits; init_cache has the JAX make_cache's leaves, shapes and dtypes,
    whatever cache_len; a JAX cache crosses bit for bit."""
    jcfg, tcfg, jp, tp = weights
    fresh_j = jax.tree.map(np.asarray, jbuild(jcfg).init_params(
        jax.random.PRNGKey(1)))
    fresh_t = build_model(tcfg).init_params(0, device="cpu")
    jflat, tflat = _flat(fresh_j), _flat(fresh_t)
    assert {p: v.shape for p, v in jflat.items()} == \
        {p: tuple(v.shape) for p, v in tflat.items()}
    for path in ("layers/ln1", "layers/tm/ln_x", "final_norm"):
        np.testing.assert_array_equal(
            jflat[path].view(np.uint16),
            tflat[path].view(torch.int16).numpy().view(np.uint16))
    carried = _flat(tp)["layers/tm/td_b"]
    np.testing.assert_array_equal(
        np.asarray(jp["layers"]["tm"]["td_b"]).view(np.uint16),
        carried.view(torch.int16).numpy().view(np.uint16))
    jc = jbuild(jcfg).init_cache(3, 16)
    for cache_len in (16, 1024):
        tc = build_model(tcfg).init_cache(3, cache_len, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tc.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    _, jc = jbuild(jcfg).prefill(jp, {"tokens": jnp.asarray(_tokens((2, 9)))})
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    for key in ("tm", "cm"):
        np.testing.assert_array_equal(
            np.asarray(jc[key]).view(np.uint16),
            tc[key].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(tc["wkv"].numpy(), np.asarray(jc["wkv"]))


@pytest.mark.parametrize("s", [40, 64, 70, 128])
def test_prefill_logits_and_cache(weights, s):
    jcfg, tcfg, jp, tp = weights
    toks = _tokens((2, s), seed=s)
    jl, jc = _strict(jbuild(jcfg).prefill, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = build_model(tcfg).prefill(
        tp, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 1, 128) and tl.dtype == torch.float32
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == s


def test_decode_steps_match_jax_and_a_longer_prefill(weights):
    """A 70-token prefill (the scan), then four decode steps at a shared
    scalar pos against JAX; the first step against a prefill of 71 tokens
    (the reference test's 0.05 relative bound,
    tests/test_models_numerics.py:123)."""
    jcfg, tcfg, jp, tp = weights
    jm, tm = jbuild(jcfg), build_model(tcfg)
    toks = _tokens((2, 71), seed=1)
    jl, jc = _strict(jm.prefill, jp, {"tokens": jnp.asarray(toks[:, :70])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :70]).long()})
    feed = toks[:, 70:]
    for step in range(4):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        if step == 0:
            full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
            err = float((tl - full).abs().max())
            assert err / float(full.abs().max()) < 0.05
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == 74


def test_slot_prefill_then_per_row_decode(weights):
    """prefill_into_slot at exact length into rows 0 and 2 of a 3-row
    cache (one chunk and the scan), row 1 untouched; then per-row decode,
    as the slot engine runs it."""
    jcfg, tcfg, jp, tp = weights
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jc = jm.init_cache(3, 128)
    jc["pos"] = jnp.zeros((3,), jnp.int32)
    tc = tm.init_cache(3, 128, device="cpu")
    tc["pos"] = torch.zeros((3,), dtype=torch.int32)
    for slot, plen in ((0, 30), (2, 90)):
        toks = _tokens((1, plen), seed=10 + slot)
        jl, jc = _strict(jm.prefill_into_slot, jp, jc, slot,
                         {"tokens": jnp.asarray(toks)}, plen)
        tl, tc = tm.prefill_into_slot(
            tp, tc, slot, {"tokens": torch.from_numpy(toks).long()}, plen)
        _logits_close(tl, jl)
    assert tc["pos"].tolist() == [30, 0, 90]
    _cache_close(tc, jc)
    for key in ("wkv", "tm", "cm"):
        assert not tc[key][:, 1].any(), key
        assert tc[key][:, 0].any() and tc[key][:, 2].any(), key
    feed = _tokens((3, 1), seed=5)
    for _ in range(3):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)


def test_loss_fn_and_grads_match_jax(weights):
    """loss_fn at T = 128 (two 64-step chunks, each past the -60 clamp at
    the initial decay: exp(-la) ~ e^60 meets exp(la) ~ e^-60, and an
    overflow or NaN would show), labels partly masked: the loss, aux 0,
    ntokens and every gradient leaf, all finite; with remat "full" (each
    layer recomputed in the backward) the loss and grads are bit-equal to
    remat "none"'s."""
    jcfg, tcfg, jp, _ = weights
    toks = _tokens((2, 129), seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    (jtotal, jmet), jg = _strict(
        jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True), jp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    runs = []
    for remat in ("none", "full"):
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                           tcfg, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, met = build_model(dataclasses.replace(
            tcfg, remat=remat)).loss_fn(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        runs.append((total, met, torch.autograd.grad(total, leaves)))
    (total, met, g0), (total1, _, g1) = runs
    assert torch.equal(total, total1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    grads = _flat(tree_unflatten(params, g0))
    assert abs(float(met["loss"].detach()) - float(jmet["loss"])) <= LOSS_ATOL
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert float(met["ntokens"]) == float(jmet["ntokens"]) == 2 * 128 - 5
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for path, j in jflat.items():
        j = np.asarray(j, np.float32)
        t = grads[path].float().numpy()
        assert np.isfinite(t).all(), path
        err = float(np.max(np.abs(t - j)))
        assert err <= GRAD_RTOL * float(np.max(np.abs(j))), (path, err)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SPECS = [(0, 5, 6, 0.0), (1, 70, 4, 0.8), (2, 64, 5, 0.0), (3, 12, 4, 0.8),
         (4, 33, 3, 0.0)]


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, 128, n).astype(np.int32)
            for rid, n, _, _ in SPECS}


def test_engine_on_replayed_jax_outputs(weights):
    """The port engine answered with the JAX engine's model outputs asks
    for the same calls (exact-length prefills: same tokens and positions)
    and emits the same tokens, at temperature 0 and 0.8."""
    jcfg, tcfg, jp, tp = weights
    prompts = _prompts()
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=128)
    rec = Replay()
    rec.record(jeng)
    jout = jeng.run([JRequest(rid=r, prompt=prompts[r], max_new_tokens=n,
                              temperature=t) for r, _, n, t in SPECS])
    teng = ServeEngine(tcfg, tp, max_batch=2, cache_len=128, device="cpu")
    rec.replay(teng)
    tout = teng.run([Request(rid=r, prompt=prompts[r], max_new_tokens=n,
                             temperature=t) for r, _, n, t in SPECS])
    rec.check_all_used()
    assert tout == jout
    assert [len(c[0][0]) for c in rec.calls["prefill"]] == [5, 70, 64, 12,
                                                            33]


def test_engine_batch_mates_paging_and_refusals(weights):
    """Each greedy request's tokens equal a solo run's (slot refills and
    batch-mates do not disturb it) and the first token is the argmax of
    model.prefill on the raw prompt; kv_page_size serves the same tokens
    unpaged (no k/v leaf to page); pad_lens, a spec engine and the
    dense-only entry points are refused, as in the JAX package."""
    _, tcfg, _, tp = weights
    prompts = _prompts()
    reqs = [Request(rid=r, prompt=prompts[r], max_new_tokens=n)
            for r, _, n, _ in SPECS]
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=128, device="cpu")
    out = eng.run(reqs)
    assert [eng._bucket_len(n, 128) for n in (5, 9, 70)] == [5, 9, 70]
    for r in reqs[:3]:
        solo = ServeEngine(tcfg, tp, max_batch=1, cache_len=128, device="cpu")
        assert solo.run([r])[r.rid] == out[r.rid], r.rid
    model = build_model(tcfg)
    logits, _ = model.prefill(
        tp, {"tokens": torch.from_numpy(prompts[0][None]).long()})
    assert out[0][0] == int(logits.reshape(-1).argmax())
    paged = ServeEngine(tcfg, tp, max_batch=2, cache_len=128, kv_page_size=8,
                        device="cpu")
    assert paged.run(reqs) == out
    assert not paged.kv.pageable
    with pytest.raises(ValueError):
        model.prefill(tp, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                           "pad_lens": torch.tensor([2])})
    assert model.prefill_continue is None and model.decode_verify is None
    draft = reduce_config(get_config("qwen2-1.5b"), layers=1, d_model=64,
                          vocab=128)
    dp = build_model(draft).init_params(1, device="cpu")
    with pytest.raises(ValueError, match="decode_verify"):
        ServeEngine(tcfg, tp, device="cpu", draft_cfg=draft,
                    draft_params=dp, spec_k=2)


def _tiny_loop(tmp_path, total_steps, ckpt_every):
    cfg = reduce_config(get_config("rwkv6-7b"), **KW)
    loop = TrainLoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                           log_every=100, ckpt_dir=str(tmp_path / "ckpt"),
                           seq_len=64, global_batch=2, peak_lr=1e-3)
    return Trainer(cfg, loop, device="cpu")


def test_trainer_runs_and_resumes_bit_equal(tmp_path):
    """4 steps in one run; 2 steps (checkpoint at 2), then a restart to 4:
    the resumed losses and the final state equal the uninterrupted
    run's."""
    full_tr = _tiny_loop(tmp_path / "a", 4, 100)
    full = full_tr.run(verbose=False)["losses"]
    assert len(full) == 4 and np.isfinite(full).all()
    _tiny_loop(tmp_path / "b", 2, 2).run(verbose=False)
    tr = _tiny_loop(tmp_path / "b", 4, 2)
    out = tr.run(verbose=False)
    assert out["start_step"] == 2
    assert out["losses"] == full[2:]
    for a, b in zip(tree_leaves(tr.state), tree_leaves(full_tr.state)):
        assert torch.equal(a, b)
