"""The port's encdec family (whisper) against the JAX package's, on the
same weights (the JAX params carried across with
convert.params_from_numpy) and the same numpy inputs, at the reduced
whisper-small (2 encoder + 2 decoder layers, d_model 64, two heads of 32,
vocab 128, enc_seq 64): the new layers (layer_norm, gelu_ffn,
sinusoid_pos, bidirectional chunked attention at a length its chunk does
not divide); the param tree and cache layout; prefill logits and
k/v/xk/xv with f32 frames (the encoder's stream stays f32 and its
projections multiply f32 activations by bf16 weights) and with bf16
frames; decode steps at a shared and at per-row positions, and
prefill_into_slot; attn_block_decode's rope switch (whisper's decoder
passes rope=False) on a rope model; loss_fn and every gradient; the
engine's greedy tokens against the JAX engine's, batch-mates undisturbed,
paged = unpaged; a Trainer that resumes bit-equal.

The JAX side is compiled with xla_allow_excess_precision off (`_strict`):
XLA otherwise keeps the decoder's bf16 adds (x + a, the bias adds, the
positions) in f32 across a fusion, where the port rounds after each op.
Compiled so, the two still differ where a bf16 rounding flips: the f32
layer_norm statistics and the tanh gelu sum in another order (a few f32
ulps), and sin/cos of the large angles of sinusoid_pos differ by a bf16
ulp at 0.05% of the 1500 x 768 table. Tolerances: the layers within
LAYER_ULPS = 1 bf16 ulp of each value's magnitude (f32 results within
F32_RTOL = 1e-6 of the largest); logits within LOGIT_ATOL = 5e-3; k/v
and xk/xv within KV_ULPS = 2 bf16 ulps of the leaf's largest value; the
loss within LOSS_ATOL = 1e-3 and every gradient leaf within GRAD_RTOL =
3e-2 of its max |JAX grad|, as tests/test_torch_train.py. Measured:
logits 4.1e-4 apart with f32 frames and 1.9e-3 with bf16 frames; k/v
within one ulp at the largest, xk/xv bit-equal with bf16 frames. Greedy
engine tokens as tests/test_torch_serve.py: logits within SERVE_TOL =
1e-2 and every top-2 margin above it, so no argmax can flip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import reduce_config as jreduce
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.registry import build_model as jbuild
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models import attention, convert, layers
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.trainer import TrainLoopConfig, Trainer

from _torch_replay import (Replay, greedy_up_to_near_ties,
                           record_sampled_logits)

LAYER_ULPS = 1.0
F32_RTOL = 1e-6
LOGIT_ATOL = 5e-3
KV_ULPS = 2 * 2.0 ** -7
LOSS_ATOL = 1e-3
GRAD_RTOL = 3e-2
SERVE_TOL = 1e-2
KW = dict(layers=2, d_model=64, vocab=128)


@pytest.fixture(scope="module")
def weights():
    jcfg = jreduce(jget("whisper-small"), **KW)
    tcfg = reduce_config(get_config("whisper-small"), **KW)
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


def _frames(b, dtype="f32", seed=0, n=64):
    """Stub frames at the Trainer's scale (N(0, 1) x 0.02), f32 or bf16."""
    f = (np.random.default_rng(100 + seed).standard_normal((b, n, 64))
         * 0.02).astype(np.float32)
    return f if dtype == "f32" else f.astype(jnp.bfloat16)


def _port(batch):
    return {k: convert.tensor_from_numpy(v, "cpu") for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _ulps(t, j):
    """Largest |t - j| in bf16 ulps of max(|j|, 1% of max |j|)."""
    t, j = np.asarray(t, np.float32), np.asarray(j, np.float32)
    scale = np.maximum(np.abs(j), 1e-2 * np.abs(j).max())
    return float(np.max(np.abs(t - j) / scale)) * 2 ** 7


def _cache_close(tc, jc):
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv", "pos"}
    for key in ("k", "v", "xk", "xv"):
        t, j = tc[key].float().numpy(), np.asarray(jc[key], np.float32)
        assert t.shape == j.shape, key
        assert tc[key].dtype == torch.bfloat16, key
        assert np.max(np.abs(t - j)) <= KV_ULPS * np.max(np.abs(j)), key
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_and_gelu_ffn_match_jax(dtype):
    """layer_norm returns x's dtype from f32 statistics (the population
    variance); gelu_ffn on an f32 x multiplies it by the bf16 weights in
    f32 (the mixed-dtype matmul), adds the biases in bf16 and takes the
    tanh gelu."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 37, 64)).astype(np.float32)
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    bf = jnp.bfloat16
    sc = (1 + 0.1 * rng.standard_normal(64)).astype(bf)
    bias = (0.1 * rng.standard_normal(64)).astype(bf)
    wi = (0.1 * rng.standard_normal((64, 192))).astype(bf)
    bi = (0.1 * rng.standard_normal(192)).astype(bf)
    wo = (0.1 * rng.standard_normal((192, 64))).astype(bf)
    bo = (0.1 * rng.standard_normal(64)).astype(bf)
    t = {k: convert.tensor_from_numpy(v, "cpu") for k, v in dict(
        x=x, sc=sc, bias=bias, wi=wi, bi=bi, wo=wo, bo=bo).items()}
    jn = jax.jit(lambda a, s, b: jlayers.layer_norm(a, s, b, 1e-5))(
        x, sc, bias)
    tn = layers.layer_norm(t["x"], t["sc"], t["bias"], 1e-5)
    assert tn.dtype == t["x"].dtype
    if dtype == "f32":
        j = np.asarray(jn)
        assert np.max(np.abs(tn.numpy() - j)) <= F32_RTOL * np.abs(j).max()
    else:
        assert _ulps(tn.float().numpy(), jn) <= LAYER_ULPS
    jf = _strict(jlayers.gelu_ffn, x, wi, bi, wo, bo)
    tf = layers.gelu_ffn(t["x"], t["wi"], t["bi"], t["wo"], t["bo"])
    assert tf.dtype == torch.bfloat16 and jf.dtype == jnp.bfloat16
    assert _ulps(tf.float().numpy(), jf) <= LAYER_ULPS


def test_sinusoid_pos_matches_jax():
    """sinusoid_pos in f32, rounded once to bf16: bit-equal at the reduced
    size; at whisper's 1500 x 768 within 2^-8 (one bf16 ulp of the values
    in [0.5, 1)) and unequal at under 0.1% of the table (f32 sin/cos of
    large angles; near a zero of sin the two can be several ulps of the
    value itself apart)."""
    for n, d, off in ((64, 64, 0), (40, 64, 7)):
        j = np.asarray(jlayers.sinusoid_pos(n, d, off), np.float32)
        t = layers.sinusoid_pos(n, d, off)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), j)
    j = np.asarray(jlayers.sinusoid_pos(1500, 768), np.float32)
    t = layers.sinusoid_pos(1500, 768).float().numpy()
    assert np.max(np.abs(t - j)) <= LAYER_ULPS * 2.0 ** -8
    assert np.mean(t != j) < 1e-3


@pytest.mark.parametrize("sq,skv,chunk", [(75, 64, 32), (1500, 1500, 512)])
def test_bidirectional_chunked_attention_matches_jax(sq, skv, chunk):
    """causal=False: every query sees every key, at a length the chunk
    does not divide (75 in chunks of 25; whisper's 1500 frames in chunks
    of 500), GQA 4 heads over 2; within one bf16 ulp at the largest |out|
    (both round p to bf16, and an f32 exp a few ulps apart moves some of
    those roundings: near-zero outputs, where the value products cancel,
    are the furthest from JAX's in their own ulps)."""
    rng = np.random.default_rng(sq)
    bf = jnp.bfloat16
    q = rng.standard_normal((2, sq, 4, 32)).astype(bf)
    k = rng.standard_normal((2, skv, 2, 32)).astype(bf)
    v = rng.standard_normal((2, skv, 2, 32)).astype(bf)
    j = jax.jit(lambda a, b, c: jattn.chunked_causal_attention(
        a, b, c, chunk=chunk, causal=False))(q, k, v)
    t = attention.chunked_causal_attention(
        *(convert.tensor_from_numpy(a, "cpu") for a in (q, k, v)),
        chunk=chunk, causal=False)
    assert t.shape == (2, sq, 4, 32) and t.dtype == torch.bfloat16
    j = np.asarray(j, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(j).max())) - 7)
    assert np.max(np.abs(t.float().numpy() - j)) <= LAYER_ULPS * ulp


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_param_tree_and_cache_layout(weights):
    """The port builds the JAX tree's paths and shapes (enc_layers,
    dec_layers with xattn, enc_ln/enc_lnb, dec_pos (32768, d),
    final_normb), the constant inits bit for bit; init_cache has the JAX
    make_cache's leaves, shapes and dtypes (xk/xv over enc_seq lines,
    whatever cache_len); a JAX cache crosses bit for bit."""
    jcfg, tcfg, jp, tp = weights
    fresh_j = jax.tree.map(np.asarray, jbuild(jcfg).init_params(
        jax.random.PRNGKey(1)))
    fresh_t = build_model(tcfg).init_params(0, device="cpu")
    jflat, tflat = _flat(fresh_j), _flat(fresh_t)
    assert {p: v.shape for p, v in jflat.items()} == \
        {p: tuple(v.shape) for p, v in tflat.items()}
    assert tflat["dec_pos"].shape == (32768, 64)
    for path in ("enc_layers/ln1", "enc_layers/ln2b", "dec_layers/lnx",
                 "dec_layers/lnxb", "dec_layers/ffn/bi", "enc_ln", "enc_lnb",
                 "final_norm", "final_normb"):
        np.testing.assert_array_equal(
            jflat[path].view(np.uint16),
            tflat[path].view(torch.int16).numpy().view(np.uint16))
    carried = _flat(tp)["dec_layers/xattn/wk"]
    np.testing.assert_array_equal(
        np.asarray(jp["dec_layers"]["xattn"]["wk"]).view(np.uint16),
        carried.view(torch.int16).numpy().view(np.uint16))
    for cache_len in (16, 96):
        jc = jbuild(jcfg).init_cache(3, cache_len)
        tc = build_model(tcfg).init_cache(3, cache_len, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tc.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    _, jc = jbuild(jcfg).prefill(jp, _jax({"tokens": _tokens((2, 9)),
                                           "frames": _frames(2)}))
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_array_equal(
            np.asarray(jc[key]).view(np.uint16),
            tc[key].view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("frames", ["f32", "bf16"])
def test_prefill_logits_and_cache(weights, frames):
    """Prefill logits and every cache leaf, f32 frames (the encoder stream
    in f32) and bf16 frames; the two frame types give different logits in
    both packages (the dtype is part of the function)."""
    jcfg, tcfg, jp, tp = weights
    batch = {"tokens": _tokens((2, 21), seed=3), "frames": _frames(2, frames)}
    jl, jc = _strict(jbuild(jcfg).prefill, jp, _jax(batch))
    tl, tc = build_model(tcfg).prefill(tp, _port(batch))
    assert tl.shape == (2, 1, 128) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == 21
    other = dict(batch, frames=_frames(2, "bf16" if frames == "f32"
                                       else "f32"))
    tl2, _ = build_model(tcfg).prefill(tp, _port(other))
    assert not torch.equal(tl, tl2)


def _padded(jc, n, cache_len):
    """A JAX prefill cache of n lines copied into a cache_len-line one."""
    out = dict(jc)
    for key in ("k", "v"):
        pad = [(0, 0)] * jc[key].ndim
        pad[2] = (0, cache_len - n)
        out[key] = jnp.pad(jc[key], pad)
    return out


def test_decode_steps_match_jax_and_a_longer_prefill(weights):
    """A 20-token prefill with f32 frames, then four decode steps at a
    shared scalar pos (dec_pos[pos] for every row) against JAX on the same
    cache; the first step against a prefill of 21 tokens (the reference
    test's 0.05 relative bound, tests/test_models_numerics.py:123)."""
    jcfg, tcfg, jp, tp = weights
    jm, tm = jbuild(jcfg), build_model(tcfg)
    toks = _tokens((2, 21), seed=4)
    fr = _frames(2, "f32", seed=4)
    _, jc = _strict(jm.prefill, jp, _jax({"tokens": toks[:, :20],
                                          "frames": fr}))
    jc = _padded(jc, 20, 32)
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    feed = toks[:, 20:]
    for step in range(4):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        if step == 0:
            full, _ = tm.prefill(tp, _port({"tokens": toks, "frames": fr}))
            err = float((tl - full).abs().max())
            assert err / float(full.abs().max()) < 0.05
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)
    assert int(tc["pos"]) == 24


def test_slot_prefill_then_per_row_decode(weights):
    """prefill_into_slot into rows 0 and 2 of a 3-row cache, right-padded
    to a 16-token bucket (prompt_len < P), bf16 and f32 frames; row 1
    untouched, xk/xv written whole; then per-row decode (dec_pos of each
    row's own pos), as the slot engine runs it."""
    jcfg, tcfg, jp, tp = weights
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jc = jm.init_cache(3, 32)
    jc["pos"] = jnp.zeros((3,), jnp.int32)
    tc = tm.init_cache(3, 32, device="cpu")
    tc["pos"] = torch.zeros((3,), dtype=torch.int32)
    for slot, plen, fr in ((0, 11, "bf16"), (2, 5, "f32")):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :plen] = _tokens((plen,), seed=10 + slot)
        batch = {"tokens": toks, "frames": _frames(1, fr, seed=slot)}
        jl, jc = _strict(jm.prefill_into_slot, jp, jc, slot, _jax(batch),
                         plen)
        tl, tc = tm.prefill_into_slot(tp, tc, slot, _port(batch), plen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    assert tc["pos"].tolist() == [11, 0, 5]
    _cache_close(tc, jc)
    for key in ("k", "v", "xk", "xv"):
        assert not tc[key][:, 1].any(), key
    assert tc["xk"][:, 0].abs().amax(dim=(1, 2, 3)).min() > 0
    feed = _tokens((3, 1), seed=5)
    for _ in range(3):
        jl, jc = _strict(jm.decode_step, jp, jc, jnp.asarray(feed))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(feed).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
        feed = np.array(jnp.argmax(jl, -1), np.int32)
    _cache_close(tc, jc)
    assert tc["pos"].tolist() == [14, 3, 8]


@pytest.mark.parametrize("rope", [True, False])
def test_attn_block_decode_rope_switch_matches_jax(rope):
    """attn_block_decode(rope=) on a rope model (reduced qwen2-1.5b, layer
    0) at per-row positions: the output and the written cache lines
    against JAX's with the same switch, within KV_ULPS of the largest; and
    rope=False differs from rope=True, so the switch is read."""
    from repro.models import transformer as jT
    from repro_torch.models import transformer as T
    jcfg = jreduce(jget("qwen2-1.5b"), **KW)
    tcfg = reduce_config(get_config("qwen2-1.5b"), **KW)
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(1))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tlp = {k: t[0] for k, t in tp["layers"]["attn"].items()}
    rng = np.random.default_rng(7)
    shape = (2, 16, tcfg.n_kv_heads, tcfg.head_dim)
    x, ck, cv = (rng.standard_normal(s).astype(jnp.bfloat16)
                 for s in ((2, 1, tcfg.d_model), shape, shape))
    pos = np.array([3, 9], np.int32)

    def port(r):
        k, v = (convert.tensor_from_numpy(a, "cpu") for a in (ck, cv))
        out, _ = T.attn_block_decode(
            tlp, convert.tensor_from_numpy(x, "cpu"), tcfg, cache_k=k,
            cache_v=v, pos=torch.from_numpy(pos), rope=r)
        return out, k, v

    out, k, v = port(rope)
    jout, (jk, jv) = _strict(
        lambda lp, x, ck, cv, pos: jT.attn_block_decode(
            lp, x, jcfg, cache_k=ck, cache_v=cv, pos=pos, rope=rope),
        jlp, *(jnp.asarray(a) for a in (x, ck, cv, pos)))
    for t, j in ((out, jout), (k, jk), (v, jv)):
        j = np.asarray(j, np.float32)
        assert np.max(np.abs(t.float().numpy() - j)) \
            <= KV_ULPS * np.max(np.abs(j))
    other, k_other, _ = port(not rope)
    assert not torch.equal(out, other) and not torch.equal(k, k_other)


def test_loss_fn_and_grads_match_jax(weights):
    """loss_fn at T = 32 with f32 frames, labels partly masked: the loss,
    aux 0, ntokens and every gradient leaf (the encoder's through the
    mixed-dtype matmuls, dec_pos's rows past T zero), all finite; with
    remat "full" the loss and grads are bit-equal to remat "none"'s."""
    jcfg, tcfg, jp, _ = weights
    toks = _tokens((2, 33), seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
             "frames": _frames(2, "f32", seed=2)}
    batch["labels"][0, :5] = -1
    (jtotal, jmet), jg = _strict(
        jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True), jp,
        _jax(batch))
    runs = []
    for remat in ("none", "full"):
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                           tcfg, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, met = build_model(dataclasses.replace(
            tcfg, remat=remat)).loss_fn(params, _port(batch))
        runs.append((total, met, torch.autograd.grad(total, leaves)))
    (total, met, g0), (total1, _, g1) = runs
    assert torch.equal(total, total1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    grads = _flat(tree_unflatten(params, g0))
    assert abs(float(met["loss"].detach()) - float(jmet["loss"])) <= LOSS_ATOL
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    assert float(met["ntokens"]) == float(jmet["ntokens"]) == 2 * 32 - 5
    assert not grads["dec_pos"][32:].any() and grads["dec_pos"][:32].any()
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

SPECS = [(0, 5, 4, "bf16"), (1, 12, 6, "f32"), (2, 9, 3, "bf16"),
         (3, 7, 5, "f32")]


def _engine_requests(cls, specs, seed=6):
    rng = np.random.default_rng(seed)
    return [cls(rid=r, prompt=rng.integers(0, 128, n).astype(np.int32),
                max_new_tokens=m, extra={"frames": _frames(1, fr, seed=r)})
            for r, n, m, fr in specs]


def test_engine_greedy_tokens_match_jax(weights, monkeypatch):
    """The port engine against the JAX engine on the same requests (bf16
    and f32 frames in Request.extra, prompts bucketed to 8 and 16, more
    requests than slots): the same schedule and per-request prompt
    lengths; along each request the logits within SERVE_TOL of JAX's and
    the greedy tokens equal up to its first near tie (a JAX top-2 margin
    within SERVE_TOL, `greedy_up_to_near_ties`: 7 of the 18 tokens are
    compared, the vocabulary of 128 leaves many near ties); and a port
    engine answered with the JAX engine's model outputs
    (tests/_torch_replay.py) asks for the same calls and emits its tokens
    exactly."""
    jcfg, tcfg, jp, tp = weights
    jeng = JEngine(jcfg, jp, max_batch=2, cache_len=32)
    teng = ServeEngine(tcfg, tp, max_batch=2, cache_len=32, device="cpu")
    jlog, tlog = {}, {}
    record_sampled_logits(monkeypatch, jeng, jlog)
    record_sampled_logits(monkeypatch, teng, tlog)
    rec = Replay()
    rec.record(jeng)
    jout = jeng.run(_engine_requests(JRequest, SPECS))
    tout = teng.run(_engine_requests(Request, SPECS))
    assert greedy_up_to_near_ties(jlog, tlog, jout, tout, SERVE_TOL) \
        >= len(SPECS)
    for key in ("decode_steps", "prefills", "new_tokens"):
        assert teng.last_stats[key] == jeng.last_stats[key], key
    assert ({r: s.prompt_len for r, s in teng.request_stats.items()}
            == {r: s.prompt_len for r, s in jeng.request_stats.items()})
    replayed = ServeEngine(tcfg, tp, max_batch=2, cache_len=32, device="cpu")
    rec.replay(replayed)
    assert replayed.run(_engine_requests(Request, SPECS)) == jout
    rec.check_all_used()


def test_engine_batch_mates_and_paging(weights):
    """Each request's greedy tokens equal a solo run's (slot refills and
    batch-mates do not disturb it); kv_page_size pages the decoder's k/v
    (xk/xv stay dense, no prefix reuse) and serves the same tokens, every
    page released; spec and the dense-only entry points are refused."""
    _, tcfg, _, tp = weights
    reqs = _engine_requests(Request, SPECS)
    eng = ServeEngine(tcfg, tp, max_batch=2, cache_len=32, device="cpu")
    out = eng.run(reqs)
    for r in reqs[1:3]:
        solo = ServeEngine(tcfg, tp, max_batch=1, cache_len=32, device="cpu")
        assert solo.run([r])[r.rid] == out[r.rid], r.rid
    paged = ServeEngine(tcfg, tp, max_batch=2, cache_len=32, kv_page_size=8,
                        device="cpu")
    assert paged.run(reqs) == out
    assert paged.kv.pageable and set(paged.kv.leaves) == {"k", "v"}
    assert not paged.kv.prefix_reuse and paged.kv.pages_live == 0
    model = build_model(tcfg)
    assert model.prefill_continue is None and model.decode_verify is None
    with pytest.raises(ValueError, match="encoder"):
        model.prefill(tp, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                           "frames": torch.zeros((1, 64, 64)),
                           "pad_lens": torch.tensor([2])})
    draft = reduce_config(get_config("qwen2-1.5b"), layers=1, d_model=64,
                          vocab=128)
    dp = build_model(draft).init_params(1, device="cpu")
    with pytest.raises(ValueError, match="decode_verify"):
        ServeEngine(tcfg, tp, device="cpu", draft_cfg=draft,
                    draft_params=dp, spec_k=2)


def _tiny_loop(tmp_path, total_steps, ckpt_every):
    cfg = reduce_config(get_config("whisper-small"), **KW)
    loop = TrainLoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                           log_every=100, ckpt_dir=str(tmp_path / "ckpt"),
                           seq_len=32, global_batch=2, peak_lr=1e-3)
    return Trainer(cfg, loop, device="cpu")


def test_trainer_runs_and_resumes_bit_equal(tmp_path):
    """4 steps in one run on the stub f32 frames; 2 steps (checkpoint at
    2), then a restart to 4: the resumed losses and the final state equal
    the uninterrupted run's."""
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
