"""The port's moe family against the JAX package's, on the same weights
(the JAX params carried across with convert.params_from_numpy) and the
same numpy tokens, at `reduce_config` of deepseek-moe-16b (a dense first
layer, "dk"/"dv" cache leaves, 8 experts top-2, shared experts) and of
llama4-maverick (no dense layer, top-1, one shared expert): prefill
logits and every cache leaf, decode steps, `loss_fn` (loss, aux and the
router, wi and shared_wo gradients); then the port's counterparts of the
JAX engine tests for moe (tests/test_serve.py:163, :183, :233 and
tests/test_kvcache.py:157), and the port engine on the JAX engine's
replayed model outputs (tests/_torch_replay.py).

Routing is a discrete choice, so the comparison holds it to margins. At
the 0.02 init the router's probabilities all lie near 1/E and a token's
k-th and (k+1)-th sit ~1e-3 apart (down to 1e-6). XLA by default may
keep bf16 intermediates in f32 across a fusion
(`xla_allow_excess_precision`), which moves activations by a bf16 ulp
and flips such a choice (a capacity cut 4.5e-5 wide flipped at 11
tokens: logits 3.4e-2 apart). So the JAX side is compiled with that
option off (`_strict`): every bf16 rounding of the model's code happens,
as it does in the port. The moe layers' inputs are then mostly bit-equal
across the packages; where a matmul's f32 sum lands on a bf16 rounding
boundary an activation moves one bf16 ulp, the router probabilities up
to 5e-5 and the logits up to 1.3e-3 (measured op by op). Every moe call of the
port's run records its margins (`_margins`): each token's k-th router
probability above its (k+1)-th, and each expert's last taken routed
weight above its first dropped one (or the cut among exact zeros, or
exact ones at k = 1), by MARGIN = 2e-4, asserted.

Tolerances: logits within LOGIT_ATOL = 5e-3 and cache lines within 2
bf16 ulps of the largest line (one rounding flip, carried a layer); the
loss within LOSS_ATOL = 1e-3, aux within AUX_ATOL = 1e-4 and every
compared gradient within GRAD_RTOL = 1e-2 of its leaf's max |JAX grad|
(the backward sums in another order). Contracts inside the port
(left-pad = unpadded, batched = solo, paged = static) are exact, as in
the reference tests."""

import contextlib
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
from repro_torch.models import moe as moe_lib
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.serve.engine import Request, ServeEngine

from _torch_replay import Replay

LOGIT_ATOL = 5e-3
KV_ULPS = 2 * 2.0 ** -7
LOSS_ATOL = 1e-3
AUX_ATOL = 1e-4
GRAD_RTOL = 1e-2
MARGIN = 2e-4
KW = dict(layers=2, d_model=64, vocab=128)
# token seeds whose routing clears MARGIN in every moe call (asserted)
SEEDS = {"deepseek-moe-16b-smoke": 7, "llama4-maverick-400b-a17b-smoke": 0,
         "slot": 1, "loss-deepseek-moe-16b-smoke": 1,
         "loss-llama4-maverick-400b-a17b-smoke": 0}
DEEPSEEK = "deepseek-moe-16b"
LLAMA4 = "llama4-maverick-400b-a17b"


def _weights(arch, seed=0):
    jcfg = jreduce(jget(arch), **KW)
    tcfg = reduce_config(get_config(arch), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(seed))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def deepseek():
    return _weights(DEEPSEEK)


@pytest.fixture(scope="module")
def llama4():
    return _weights(LLAMA4)


@pytest.fixture
def weights(request, deepseek, llama4):
    return {DEEPSEEK: deepseek, LLAMA4: llama4}[request.param]


ARCHS = pytest.mark.parametrize("weights", [DEEPSEEK, LLAMA4],
                                indirect=True)


@contextlib.contextmanager
def _margins():
    """While open, every moe_ffn call records its smallest routing margin
    (router top-k and capacity cut; see the module docstring) into the
    yielded list; on exit each must exceed MARGIN."""
    seen = []
    real = moe_lib.moe_ffn

    def spy(x, params, *, n_experts, k, token_valid=None, **kw):
        token, cut = moe_lib.routing_margins(
            x, params["router"], n_experts=n_experts, k=k,
            token_valid=token_valid)
        seen.append(float(min(token.min(), cut.min())))
        return real(x, params, n_experts=n_experts, k=k,
                    token_valid=token_valid, **kw)

    moe_lib.moe_ffn = spy
    try:
        yield seen
    finally:
        moe_lib.moe_ffn = real
    assert seen and min(seen) > MARGIN, seen


def _strict(fn, *args):
    """fn(*args) jitted with xla_allow_excess_precision off (see the module
    docstring)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(np.int32)


def _logits_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_ATOL,
                               rtol=0)


def _cache_close(tc, jc):
    assert set(tc) == set(jc)
    for key, j in jc.items():
        if key == "pos":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(j))
            continue
        t, j = tc[key].float().numpy(), np.asarray(j, np.float32)
        assert t.shape == j.shape, key
        assert np.max(np.abs(t - j)) <= KV_ULPS * np.max(np.abs(j)), key


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_params_and_cache_round_trip(deepseek):
    """The moe tree and a cache with dk/dv cross bit for bit; the port
    builds the same paths and shapes, and a missing leaf raises."""
    jcfg, tcfg, jp, tp = deepseek
    jflat, tflat = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert set(jflat) == set(tflat)
    assert {"dense_layers/ffn/wi", "layers/moe/router", "layers/moe/wi",
            "layers/moe/shared_wo"} <= set(tflat)
    for path in ("dense_layers/ffn/wi", "layers/moe/wg", "layers/moe/router"):
        np.testing.assert_array_equal(
            jflat[path].view(np.uint16),
            tflat[path].view(torch.int16).numpy().view(np.uint16))
    shapes = build_model(tcfg).init_params(0, device="cpu")
    assert {p: tuple(v.shape) for p, v in _flat(shapes).items()} == \
        {p: tuple(v.shape) for p, v in jflat.items()}
    bad = jax.tree.map(np.asarray, jp)
    del bad["layers"]["moe"]["shared_wg"]
    with pytest.raises(ValueError):
        convert.params_from_numpy(bad, tcfg, device="cpu")
    _, jc = jbuild(jcfg).prefill(jp, {"tokens": jnp.asarray(_tokens((2, 9)))})
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    assert set(tc) == {"k", "v", "dk", "dv", "pos"}
    for key in ("dk", "v"):
        np.testing.assert_array_equal(
            np.asarray(jc[key]).view(np.uint16),
            tc[key].view(torch.int16).numpy().view(np.uint16))
    empty = build_model(tcfg).init_cache(3, 16, device="cpu")
    assert empty["dk"].shape == (1, 3, 16, tcfg.n_kv_heads, tcfg.head_dim)
    assert empty["k"].shape == (1, 3, 16, tcfg.n_kv_heads, tcfg.head_dim)


@ARCHS
def test_prefill_then_decode_match_jax(weights):
    """Prefill logits and cache leaves (dk/dv included), then three decode
    steps at a shared scalar pos: logits and the grown cache."""
    jcfg, tcfg, jp, tp = weights
    jm, tm = jbuild(jcfg), build_model(tcfg)
    toks = _tokens((2, 24), seed=SEEDS[tcfg.name])
    room = 4
    jl, jc = _strict(jm.prefill, jp, {"tokens": jnp.asarray(toks)})
    with _margins():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 1, 128) and tl.dtype == torch.float32
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    jc = {k: v if k == "pos" else jnp.pad(
        v, ((0, 0), (0, 0), (0, room), (0, 0), (0, 0))) for k, v in jc.items()}
    tc = {k: v if k == "pos" else torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, room)) for k, v in tc.items()}
    feed = toks[:, -1:]
    for step in range(3):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        with _margins():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        assert int(tc["pos"]) == int(jc["pos"]) == 24 + step + 1
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)


def test_slot_prefill_then_per_row_decode_match_jax(deepseek):
    """prefill_into_slot at exact length into row 1 of a two-row slot
    cache (both dk/dv and k/v written), then per-row decode with row 0 at
    another offset, as the slot engine runs it."""
    jcfg, tcfg, jp, tp = deepseek
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jc = jm.init_cache(2, 32)
    jc["pos"] = jnp.array([3, 0], jnp.int32)
    tc = tm.init_cache(2, 32, device="cpu")
    tc["pos"] = torch.tensor([3, 0], dtype=torch.int32)
    prompt = _tokens((1, 11), seed=SEEDS["slot"])
    jl, jc = _strict(jm.prefill_into_slot, jp, jc, 1,
                    {"tokens": jnp.asarray(prompt)}, 11)
    with _margins():
        tl, tc = tm.prefill_into_slot(
            tp, tc, 1, {"tokens": torch.from_numpy(prompt).long()}, 11)
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    feed = _tokens((2, 1), seed=SEEDS["slot"])
    for _ in range(2):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        with _margins():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        _logits_close(tl, jl)
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)


@pytest.mark.parametrize("weights,remat", [(DEEPSEEK, "none"),
                                           (DEEPSEEK, "full"),
                                           (LLAMA4, "none")],
                         indirect=["weights"])
def test_loss_fn_and_router_grads_match_jax(weights, remat):
    """loss_fn's loss and aux (summed over the moe layers, added at
    router_aux_coef), and the gradients through the router (the top-k
    weights and the aux), the experts and the shared experts."""
    jcfg, tcfg, jp, tp = weights
    toks = _tokens((2, 33), seed=SEEDS["loss-" + tcfg.name])
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    (jtotal, jmet), jg = _strict(
        jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True), jp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    cfg = dataclasses.replace(tcfg, remat=remat)
    with _margins():
        total, met = build_model(cfg).loss_fn(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        grads = _flat(tree_unflatten(params,
                                     torch.autograd.grad(total, leaves)))
    met = {k: float(v.detach()) for k, v in met.items()}
    assert abs(met["loss"] - float(jmet["loss"])) <= LOSS_ATOL
    assert met["aux"] > 0.5        # ~1 a layer at balanced routing
    assert abs(met["aux"] - float(jmet["aux"])) <= AUX_ATOL
    assert abs(float(total.detach()) - float(jtotal)) <= LOSS_ATOL
    assert met["ntokens"] == float(jmet["ntokens"]) == 2 * 32 - 5
    compared = 0
    for path, j in _flat(jax.tree.map(np.asarray, jg)).items():
        if path.split("/")[-1] not in ("router", "wi", "shared_wo"):
            continue
        j = np.asarray(j, np.float32)
        err = float(np.max(np.abs(grads[path].float().numpy() - j)))
        assert np.max(np.abs(j)) > 0, path
        assert err <= GRAD_RTOL * float(np.max(np.abs(j))), (path, err)
        compared += 1
    assert compared == (4 if "dense_layers" in params else 3)


# ---------------------------------------------------------------------------
# the engine (the JAX engine tests for moe, tests/test_serve.py and
# tests/test_kvcache.py, on the port)
# ---------------------------------------------------------------------------

def test_left_pad_prefill_matches_unpadded(deepseek):
    """tests/test_serve.py:163: pad tokens claim no expert capacity (at 16
    and 19 tokens, E=8, k=2, cf 1.25 both give C=5), so a left-padded
    prefill's logits equal the unpadded prompt's (the reference test's
    atol 1e-5), on the reference test's weights (seed 1); and JAX's."""
    jcfg, tcfg, _, _ = deepseek
    _, _, jp1, tp1 = _weights(DEEPSEEK, seed=1)
    tm = build_model(tcfg)
    prompt = (np.arange(16, dtype=np.int32) * 5) % 128
    l0, _ = tm.prefill(tp1, {"tokens": torch.from_numpy(prompt[None]).long()})
    padded = np.concatenate([np.zeros(3, np.int32), prompt])
    with _margins():
        lp, cache = tm.prefill(tp1, {
            "tokens": torch.from_numpy(padded[None]).long(),
            "pad_lens": torch.tensor([3], dtype=torch.int32)})
    np.testing.assert_allclose(lp.numpy(), l0.numpy(), rtol=0, atol=1e-5)
    jl, _ = _strict(jbuild(jcfg).prefill, jp1, {
        "tokens": jnp.asarray(padded[None]),
        "pad_lens": jnp.asarray(np.array([3], np.int32))})
    _logits_close(lp, jl)
    assert cache["dk"].shape[2] == 19


def test_slot_engine_refills_without_disturbing_batch_mates(deepseek):
    """tests/test_serve.py:183 for moe: three requests through two slots
    serve the tokens each serves alone (exact-length admission, decode
    over every slot)."""
    _, tcfg, _, tp = deepseek

    def mk(rid, n, new):
        return Request(rid=rid, prompt=np.arange(n) % 128, max_new_tokens=new)

    reqs = [mk(i, 4 + i, 3 if i % 2 else 7) for i in range(3)]
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=64, device="cpu")
    out = eng.run(reqs)
    assert [eng._bucket_len(n, 64) for n in (5, 9, 33)] == [5, 9, 33]
    for r in reqs:
        solo = ServeEngine(tcfg, tp, max_batch=1, cache_len=64, device="cpu")
        assert solo.run([mk(r.rid, len(r.prompt), r.max_new_tokens)])[r.rid] \
            == out[r.rid]


def test_engine_on_replayed_jax_outputs(deepseek):
    """The port engine answered with the JAX engine's model outputs
    (tests/_torch_replay.py) asks for the same calls (exact-length
    prefills: same tokens and positions) and emits the same tokens, at
    temperature 0 and 0.8."""
    jcfg, tcfg, jp, tp = deepseek
    specs = [(0, 5, 6, 0.0), (1, 9, 3, 0.8), (2, 3, 5, 0.0), (3, 12, 4, 0.8),
             (4, 7, 2, 0.0)]
    rng = np.random.default_rng(3)
    prompts = {rid: rng.integers(0, 128, n).astype(np.int32)
               for rid, n, _, _ in specs}
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=64)
    rec = Replay()
    rec.record(jeng)
    jout = jeng.run([JRequest(rid=r, prompt=prompts[r], max_new_tokens=n,
                              temperature=t) for r, _, n, t in specs])
    teng = ServeEngine(tcfg, tp, max_batch=2, cache_len=64, device="cpu")
    rec.replay(teng)
    tout = teng.run([Request(rid=r, prompt=prompts[r], max_new_tokens=n,
                             temperature=t) for r, _, n, t in specs])
    rec.check_all_used()
    assert tout == jout
    assert [len(c[0][0]) for c in rec.calls["prefill"]] == [5, 9, 3, 12, 7]


def test_slot_prefill_matches_exact_model(deepseek):
    """tests/test_serve.py:233: the engine's first token is the argmax of
    model.prefill on the raw prompt (5 tokens: no shape bucket)."""
    _, tcfg, _, tp = deepseek
    prompt = (np.arange(5, dtype=np.int32) * 7) % 128
    logits, _ = build_model(tcfg).prefill(
        tp, {"tokens": torch.from_numpy(prompt[None]).long()})
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=64, device="cpu")
    out = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=1)])
    assert out[0] == [int(logits.reshape(-1).argmax())]


def test_paged_tokens_equal_static(deepseek):
    """tests/test_kvcache.py:157 for deepseek: the paged engine (k/v and
    dk/dv leaves paged, no prefix reuse for moe) serves the static
    engine's tokens and releases every page."""
    _, tcfg, _, tp = deepseek
    reqs = [Request(rid=i, prompt=np.arange(4 + 3 * i) % 128,
                    max_new_tokens=3 + 2 * (i % 2)) for i in range(4)]
    base = ServeEngine(tcfg, tp, max_batch=2, cache_len=64,
                       device="cpu").run(reqs)
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=64, kv_page_size=8,
                      device="cpu")
    assert eng.run(reqs) == base
    assert set(eng.kv.leaves) == {"k", "v", "dk", "dv"}
    assert not eng.kv.prefix_reuse
    eng.kv.check_conservation()
    assert eng.kv.pages_live == 0


def test_moe_has_no_verify_or_continue(deepseek, llama4):
    """As in the JAX package: no prefix-continue prefill and no
    multi-position verify for moe, so a spec engine on a moe target
    raises; llama4's cache has no dk/dv."""
    _, tcfg, _, tp = deepseek
    model = build_model(tcfg)
    assert model.prefill_continue is None and model.decode_verify is None
    draft = reduce_config(get_config("qwen2-1.5b"), layers=1, d_model=64,
                          vocab=128)
    dp = build_model(draft).init_params(1, device="cpu")
    with pytest.raises(ValueError, match="decode_verify.*item 8.1"):
        ServeEngine(tcfg, tp, device="cpu", draft_cfg=draft,
                    draft_params=dp, spec_k=2)
    _, lcfg, _, _ = llama4
    assert set(build_model(lcfg).init_cache(1, 8, device="cpu")) == \
        {"k", "v", "pos"}
