"""The port's moe layer (`repro_torch.models.moe`) against the JAX
package's (`repro.models.moe`) on the same numpy inputs: `router_topk`
(weights, ids, aux) and `moe_ffn` (the tokens each expert takes, their
gates, the output, aux) with and without drops, with `token_valid`, with
and without shared experts, at decode's C = 1, on a fixture whose routed
rows tie (the lower token index must win, as `lax.top_k` picks); then the
dispatch against a per-token expert loop (tests/test_models_numerics.py's
`test_moe_dispatch_matches_naive`).

Tolerances, stated per quantity:
  * router weights within WEIGHT_ATOL = 1e-6 and aux within AUX_RTOL =
    1e-6 relative: both sides compute the logits, softmax and sums in f32
    in their own order (an f32 ulp is 6e-8 at 1);
  * ids and `gather_idx` equal. Every fixture asserts its own margins
    first: each token's k-th router probability exceeds its (k+1)-th by
    MARGIN = 1e-4, and each expert's last taken routed weight exceeds its
    first dropped one by MARGIN, or the cut falls among exact zeros (the
    filler picks, ordered by index on both sides) or among weights of
    exactly 1 (top-1 routing);
  * gates within WEIGHT_ATOL;
  * the output within OUT_ULPS = 2 bf16 ulps of max |out|: the expert
    products round to bf16 after an f32 sum whose order differs.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.convert import tensor_from_numpy

WEIGHT_ATOL = 1e-6
AUX_RTOL = 1e-6
MARGIN = 1e-4
OUT_ULPS = 2 * 2.0 ** -8


def _bf16(a):
    """numpy float -> numpy bfloat16 (round to nearest even), as JAX."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16))


def _layer(seed, t, d, e, f, *, shared=True, router_scale=0.2):
    """x (T, D) and one moe layer's params, bf16 numpy, from a seed."""
    rng = np.random.default_rng(seed)
    p = {"router": _bf16(router_scale * rng.standard_normal((d, e))),
         "wi": _bf16(0.2 * rng.standard_normal((e, d, f))),
         "wg": _bf16(0.2 * rng.standard_normal((e, d, f))),
         "wo": _bf16(0.2 * rng.standard_normal((e, f, d)))}
    if shared:
        p.update(shared_wi=_bf16(0.2 * rng.standard_normal((d, 2 * f))),
                 shared_wg=_bf16(0.2 * rng.standard_normal((d, 2 * f))),
                 shared_wo=_bf16(0.2 * rng.standard_normal((2 * f, d))))
    return _bf16(rng.standard_normal((t, d))), p


def _torch(tree):
    return {k: tensor_from_numpy(v, "cpu") for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _jax_dispatch(x, p, e, k, cf, valid):
    """The reference's dispatch (repro/models/moe.py:52-69) step by step:
    (routed (E, T), gate (E, C), gather_idx (E, C), router probs)."""
    t = x.shape[0]
    xj = jnp.asarray(x)
    weights, ids, _ = jmoe.router_topk(xj, jnp.asarray(p["router"]), k)
    if valid is not None:
        weights = weights * jnp.asarray(valid)[:, None].astype(weights.dtype)
    c = min(int(max(1, (t * k * cf) // e)), t)
    routed = jnp.zeros((e, t), jnp.float32).at[
        ids.reshape(-1), jnp.repeat(jnp.arange(t), k)].add(weights.reshape(-1))
    gate, gather_idx = jax.lax.top_k(routed, c)
    logits = xj.astype(jnp.float32) @ jnp.asarray(p["router"], jnp.float32)
    return (np.asarray(routed), np.asarray(gate), np.asarray(gather_idx),
            np.asarray(jax.nn.softmax(logits, -1)))


def _assert_margins(probs, routed, k, c):
    """The fixture's own margins: router top-k and every expert's cut."""
    top = -np.sort(-probs, axis=-1)
    if k < probs.shape[-1]:
        assert np.all(top[:, k - 1] - top[:, k] > MARGIN), \
            float(np.min(top[:, k - 1] - top[:, k]))
    rows = -np.sort(-routed, axis=-1)
    if c < routed.shape[1]:
        cut = rows[:, c - 1] - rows[:, c]
        # a tie at an exact value (0 past the routed tokens; 1 for every
        # routed token at k = 1) is decided by index alone on both sides
        exact = (rows[:, c - 1] == 0.0) | ((cut == 0.0) & (rows[:, c] == 1.0))
        assert np.all((cut > MARGIN) | exact), cut


def _out_close(got, want):
    want = np.asarray(want, np.float32)
    err = np.max(np.abs(got.float().numpy() - want))
    assert err <= OUT_ULPS * np.max(np.abs(want)), err


@pytest.mark.parametrize("seed,t,e,k", [(1, 64, 8, 2), (8, 48, 64, 6),
                                        (1, 16, 16, 1)])
def test_router_topk_matches_jax(seed, t, e, k):
    x, p = _layer(seed, t, 32, e, 8)
    jw, jids, jaux = jmoe.router_topk(jnp.asarray(x), jnp.asarray(p["router"]),
                                      k)
    tw, tids, taux = moe.router_topk(tensor_from_numpy(x, "cpu"),
                                     tensor_from_numpy(p["router"], "cpu"), k)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(x, jnp.float32) @ jnp.asarray(p["router"], jnp.float32)))
    top = -np.sort(-probs, axis=-1)
    # ids in order: every adjacent pair of the top k+1 apart by MARGIN
    gaps = top[:, :min(k + 1, e)][:, :-1] - top[:, 1:min(k + 1, e)]
    assert np.all(gaps > MARGIN), float(np.min(gaps))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=WEIGHT_ATOL,
                               rtol=0)
    assert tw.dtype == torch.float32 and taux.dtype == torch.float32
    assert float(taux) == pytest.approx(float(jaux), rel=AUX_RTOL)


CASES = {
    # name: (seed, T, E, k, F, capacity factor, shared, pad tokens)
    "drops": (2, 64, 8, 2, 24, 1.25, True, 0),
    "no-drops": (2, 64, 8, 2, 24, 8.0, True, 0),
    "token-valid": (3, 64, 8, 2, 24, 1.25, True, 11),
    "no-shared": (4, 64, 8, 2, 24, 1.25, False, 0),
    "deepseek-like": (1, 64, 16, 6, 16, 1.25, True, 0),
    "decode-c1": (6, 4, 16, 6, 16, 1.25, True, 0),
    "top1": (7, 32, 8, 1, 24, 1.25, True, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_jax(name):
    seed, t, e, k, f, cf, shared, pads = CASES[name]
    x, p = _layer(seed, t, 32, e, f, shared=shared)
    valid = None
    if pads:
        valid = np.ones(t, bool)
        valid[np.random.default_rng(seed).choice(t, pads, replace=False)] = 0
    routed, jgate, jidx, probs = _jax_dispatch(x, p, e, k, cf, valid)
    c = jidx.shape[1]
    assert c == moe.capacity(t, k, e, cf)
    _assert_margins(probs, routed, k, c)
    if name == "drops":
        assert np.sum(routed > 0) > np.sum(jgate > 0)   # some tokens drop
    if name == "no-drops":
        assert np.sum(routed > 0) == np.sum(jgate > 0)
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), _jax(p), n_experts=e, k=k,
                              capacity_factor=cf,
                              token_valid=None if valid is None
                              else jnp.asarray(valid))
    tx, tp = tensor_from_numpy(x, "cpu"), _torch(p)
    tvalid = None if valid is None else torch.from_numpy(valid)
    tout, taux = moe.moe_ffn(tx, tp, n_experts=e, k=k, capacity_factor=cf,
                             token_valid=tvalid)
    gate, gather_idx, _, _ = moe.dispatch(tx, tp["router"], n_experts=e, k=k,
                                          capacity_factor=cf,
                                          token_valid=tvalid)
    np.testing.assert_array_equal(gather_idx.numpy(), jidx)
    np.testing.assert_allclose(gate.numpy(), jgate, atol=WEIGHT_ATOL,
                               rtol=0)
    assert tout.dtype == torch.bfloat16 and tout.shape == (t, 32)
    _out_close(tout, jout)
    assert float(taux) == pytest.approx(float(jaux), rel=AUX_RTOL)
    if valid is not None:   # a pad token claims no slot with a nonzero gate
        picked = gather_idx[gate > 0].numpy()
        assert valid[picked].all()


@pytest.mark.parametrize("t", [8, 4])
def test_ties_go_to_the_lower_index(t):
    """Every token the same: each routed row holds T equal weights (or
    zeros), so which tokens an expert takes is decided by the tie rule
    alone: the lowest indices, on both sides."""
    x, p = _layer(8, 1, 32, 8, 16, router_scale=2.0)
    x = np.repeat(x, t, axis=0)
    routed, jgate, jidx, _ = _jax_dispatch(x, p, 8, 2, 1.25, None)
    c = jidx.shape[1]
    assert c < t and len(np.unique(routed[routed > 0])) <= 2
    np.testing.assert_array_equal(jidx,
                                  np.broadcast_to(np.arange(c), jidx.shape))
    jout, _ = jmoe.moe_ffn(jnp.asarray(x), _jax(p), n_experts=8, k=2)
    tx, tp = tensor_from_numpy(x, "cpu"), _torch(p)
    tout, _ = moe.moe_ffn(tx, tp, n_experts=8, k=2)
    _, gather_idx, _, _ = moe.dispatch(tx, tp["router"], n_experts=8, k=2)
    np.testing.assert_array_equal(gather_idx.numpy(), jidx)
    _out_close(tout, jout)
    # the tokens past the cut got the shared experts only
    np.testing.assert_array_equal(tout[c:].float().numpy(),
                                  tout[c:c + 1].float().expand(t - c, -1)
                                  .numpy())
    assert not torch.equal(tout[0], tout[c])


def test_moe_dispatch_matches_naive():
    """Capacity dispatch == a per-token loop over each token's top-k
    experts in float32 (capacity high enough that nothing drops), at the
    reference test's sizes and tolerance (atol 0.05, rtol 0.1: the loop
    keeps f32 where the layer rounds to bf16)."""
    T, D, E, K, F = 32, 16, 4, 2, 24
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((T, D)))
    p = {"router": _bf16(0.5 * rng.standard_normal((D, E))),
         "wi": _bf16(0.1 * rng.standard_normal((E, D, F))),
         "wg": _bf16(0.1 * rng.standard_normal((E, D, F))),
         "wo": _bf16(0.1 * rng.standard_normal((E, F, D)))}
    out, aux = moe.moe_ffn(tensor_from_numpy(x, "cpu"), _torch(p),
                           n_experts=E, k=K, capacity_factor=8.0)
    f32 = {k: np.asarray(v, np.float32) for k, v in p.items()}
    xf = np.asarray(x, np.float32)
    logits = xf @ f32["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = np.zeros((T, D), np.float32)
    for t in range(T):
        top = np.argsort(-probs[t])[:K]
        wsum = probs[t, top].sum()
        for e in top:
            h = xf[t] @ f32["wi"][e]
            g = xf[t] @ f32["wg"][e]
            ref[t] += probs[t, e] / wsum * ((h * (g / (1 + np.exp(-g))))
                                             @ f32["wo"][e])
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.05, rtol=0.1)
    assert np.isfinite(float(aux))


def test_forward_has_no_atomics_and_no_host_sync():
    """The forward's scatters are indexed writes and gathers: no
    index_add_/scatter_add_ (atomics on CUDA), and nothing reads a value
    back to the host."""
    src = "".join(inspect.getsource(f) for f in (
        moe._top_k, moe.router_topk, moe._routed, moe.dispatch, moe.moe_ffn))
    for banned in (r"index_add", r"scatter_add", r"scatter_reduce",
                   r"\.item\(", r"\.cpu\(", r"\.tolist\(", r"\.numpy\(",
                   r"torch\.topk"):
        assert not re.search(banned, src), banned
