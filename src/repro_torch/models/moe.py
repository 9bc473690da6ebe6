"""Mixture-of-Experts FFN — the port of `repro.models.moe` (`router_topk`
:25, `moe_ffn` :41): top-k routing, capacity-based static dispatch,
shared experts, the Switch load-balance aux loss.

Dispatch, as in the JAX package: for each expert the top `capacity`
tokens of its (E, T) routed-weight row are gathered to (E, C, D), run
through the expert SwiGLU as batched products (bf16 operands, f32
accumulator, bf16 out: the reference's `einsum`), weighted by their gate
in f32 and added back per token. Tokens past an expert's capacity are
dropped; capacity is static, from T.

Exactness on the card, where the reference pins it:

  * `lax.top_k` breaks ties toward the lower index; `torch.topk` makes no
    promise, so both top-k sites take a stable descending sort and slice
    (`_top_k`). At decode (T = 4, C = 1) most of a routed row is 0 and
    every filler pick is a tie.
  * the two `.at[].add` scatters run in a fixed order with no atomics
    (`index_add_` and `scatter_add_` on CUDA use atomics). The routed
    matrix has no duplicate (e, t) pair, so an indexed write fills it.
    The combine adds each token's contributions in ascending expert order
    from 0.0, as XLA's sequential scatter does: only a token's own k
    experts carry a nonzero gate (a filler pick adds an exact zero, a
    no-op on an accumulator that is never -0.0), so an (E, T) slot map
    from `gather_idx` finds each of them, and k adds sum them.

Nothing here reads a value back to the host. Under exact-TP serving
(layers.exact_tp_scope) the expert and shared up-projections give this
rank's d_ff columns, gathered before the down-projections, which every
rank computes whole.

`moe_ffn_ep` (:102-201 of the reference) is the expert-parallel route
over the data axes: each rank routes its own tokens, sends each route to
the rank that owns its expert (an all_to_all, `AllToAll`, whose backward
is the inverse exchange), runs a second capacity dispatch over its local
experts, and sends the results back to be combined where the tokens
live. Both of the reference's branches are ported: with `tp` (its
`has_tp`, the training plan over a model axis) the experts' d_ff is
split over the model group too, and their partial products are summed
over it in bf16 before the pick weight and the return exchange, where
the reference puts its psum. `moe_ffn_ep_emulated` runs the same three
stages for every shard in one process, the exchange as tensor indexing
(and `tp_shards` the model ranks' d_ff blocks): the rank world's
function on one device, which the tests hold the ranks to bit for bit.
`moe_ffn` under a split d_ff (the capacity route in tensor-parallel
training) sums its experts' partials over the model group the same way.

`dispatch` is moe_ffn's routing alone, which the checks compare across
devices; `routing_margins` and `settled` are check helpers (how far a
routing is from flipping, and which of its parts two devices may be held
to), called by the tests and chip_smoke.py, never by the model.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist.collectives import copy_to, reduce_from
from repro_torch.models.layers import (PARAM_DTYPE, gather_exact_tp, matmul,
                                       swiglu)

Tensor = torch.Tensor


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis and their indices, ties
    toward the lower index (`lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(x: torch.Tensor, w_router: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (weights (T, k) f32, ids (T, k) int64, aux 0-d f32).

    Logits and softmax in f32; the top-k weights renormalised to sum 1
    (floor 1e-9); aux = E * sum_e f_e p_e, f the top-1 assignment share
    and p the mean router probability of expert e."""
    logits = torch.matmul(x.float(), w_router.float())          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = _top_k(probs, k)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    e = probs.shape[-1]
    assign = torch.nn.functional.one_hot(ids[:, 0], e).float()
    aux = e * torch.sum(assign.mean(0) * probs.mean(0))
    return weights, ids, aux


def capacity(t: int, k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Tokens an expert takes: min(T, max(1, floor(T k cf) // E))."""
    return min(int(max(1, (t * k * capacity_factor) // n_experts)), t)


def _routed(weights: torch.Tensor, ids: torch.Tensor, n_experts: int
            ) -> torch.Tensor:
    """(E, T): the routed weight of each token for each expert, 0 where the
    token is not routed there (no (e, t) pair repeats: one write each)."""
    t, k = ids.shape
    tok = torch.arange(t, device=ids.device)[:, None].expand(t, k)
    routed = torch.zeros((n_experts, t), dtype=torch.float32,
                         device=ids.device)
    return routed.index_put((ids, tok), weights)


@torch.no_grad()
def routing_margins(x: torch.Tensor, w_router: torch.Tensor, *,
                    n_experts: int, k: int, capacity_factor: float = 1.25,
                    token_valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """How far moe_ffn's two discrete choices on x are from flipping:
    (token (T,): each token's k-th router probability minus its (k+1)-th;
    cut (E,): each expert's last taken routed weight minus its first
    dropped one). inf where nothing can flip: k = E, C = T, or a cut
    among weights that are exactly equal on any device (0, past the
    routed tokens; 1, every routed token's weight at k = 1), which the
    lower index decides. Two runs whose inputs differ by less than these
    margins route alike."""
    probs = torch.softmax(torch.matmul(x.float(), w_router.float()), -1)
    top = torch.sort(probs, dim=-1, descending=True)[0]
    inf = torch.full((x.shape[0],), float("inf"), device=x.device)
    token = top[:, k - 1] - top[:, k] if k < n_experts else inf
    weights, ids, _ = router_topk(x, w_router, k)
    if token_valid is not None:
        weights = weights * token_valid[:, None].to(weights.dtype)
    t = x.shape[0]
    c = capacity(t, k, n_experts, capacity_factor)
    rows = torch.sort(_routed(weights, ids, n_experts), dim=-1,
                      descending=True)[0]
    if c == t:
        return token, torch.full((n_experts,), float("inf"), device=x.device)
    cut = rows[:, c - 1] - rows[:, c]
    exact = (rows[:, c - 1] == 0) | ((cut == 0) & (rows[:, c] == 1))
    return token, torch.where(exact, float("inf"), cut)


@torch.no_grad()
def settled(x: torch.Tensor, w_router: torch.Tensor, gate: torch.Tensor, *,
            n_experts: int, k: int, margin: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which parts of a moe_ffn run on x (gates (E, C), as `dispatch`
    returns them) no change below `margin` in the router's inputs can
    move: (experts (E,) whose picks, gather_idx and gates, are settled,
    tokens (T,) whose output is), bool. What two devices may be held to.

    A shaky token (k-th and (k+1)-th router probabilities within the
    margin) may take either of those two experts. An expert's picks are
    settled when its cut clears the margin and no shaky token may take
    it. A token's place in an expert is settled when the cut clears the
    margin and no shaky token can displace a pick: the expert is under
    capacity (its lowest pick a filler 0: one token more or less still
    fits), or the shaky token's k-th weight lies below the lowest pick by
    the margin. A token's output is settled when it is not shaky and its
    place in each of its k experts is."""
    token, cut = routing_margins(x, w_router, n_experts=n_experts, k=k)
    _, near, _ = router_topk(x, w_router, k + 1)
    wk = router_topk(x, w_router, k)[0][:, k - 1]           # k-th weight
    shaky = token <= margin
    picks, places = cut > margin, cut > margin
    either = near[shaky][:, k - 1:k + 1]                    # (S, 2)
    lowest = gate[:, -1][either]
    picks[either.reshape(-1)] = False
    bump = (lowest > 0) & (wk[shaky][:, None] + margin >= lowest)
    places[either[bump]] = False
    return picks, ~shaky & places[near[:, :k]].all(1)


def dispatch(x: torch.Tensor, w_router: torch.Tensor, *, n_experts: int,
             k: int, capacity_factor: float = 1.25, token_valid=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """moe_ffn's routing of x (T, D): (gate (E, C) f32 and gather_idx (E, C),
    the tokens each expert takes and their weights; ids (T, k), each
    token's experts; aux 0-d f32).

    token_valid: optional (T,) bool; an invalid (pad) token gets router
    weight 0, so it claims no capacity from real tokens and adds nothing
    (capacity itself stays derived from T)."""
    weights, ids, aux = router_topk(x, w_router, k)
    if token_valid is not None:
        weights = weights * token_valid[:, None].to(weights.dtype)
    c = capacity(x.shape[0], k, n_experts, capacity_factor)
    gate, gather_idx = _top_k(_routed(weights, ids, n_experts), c)
    return gate, gather_idx, ids, aux


def moe_ffn(x: torch.Tensor, params, *, n_experts: int, k: int,
            capacity_factor: float = 1.25, token_valid=None, tp=None,
            shared_tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) bf16. params: {router (D, E), wi/wg (E, D, F), wo (E, F,
    D), shared_wi/wg (D, Fs) and shared_wo (Fs, D) optional}. Returns
    (out (T, D) bf16, aux 0-d f32). token_valid as in `dispatch`.

    tp / shared_tp: the model group where the training plan splits the
    experts' / the shared experts' d_ff over it (wi/wg this rank's
    columns, wo its rows): the gathered tokens enter through CopyToGroup
    and the experts' partial products are summed over the group
    (ReduceFromGroup) before the gate; the shared experts are a dense
    row-parallel SwiGLU."""
    t, d = x.shape
    dev = x.device
    gate, gather_idx, ids, aux = dispatch(
        x, params["router"], n_experts=n_experts, k=k,
        capacity_factor=capacity_factor, token_valid=token_valid)
    c = gate.shape[1]
    x_e = x[gather_idx.reshape(-1)].reshape(n_experts, c, d)     # (E, C, D)
    x_e = copy_to(x_e, tp)
    h = matmul(x_e, params["wi"])
    g = matmul(x_e, params["wg"])
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    if tp is None:
        # exact-TP serving: h's F dim is this rank's column shard;
        # gathered, so the down-projection contracts whole on every rank
        h = gather_exact_tp(h, params["wo"].shape[-2])
    y_e = reduce_from(matmul(h, params["wo"]), tp)               # (E, C, D)
    y_e = y_e.float() * gate[..., None]

    # combine: slot[e, t] is the slot of token t in expert e's picks (c,
    # past the last slot, where e did not take t); a token's own experts
    # in ascending order, each contribution from its slot (a zero row for
    # a dropped one), added from 0.0 one expert at a time
    slot = torch.full((n_experts, t), c, dtype=torch.long, device=dev)
    slot = slot.index_put(
        (torch.arange(n_experts, device=dev)[:, None].expand(n_experts, c),
         gather_idx), torch.arange(c, device=dev).expand(n_experts, c))
    mine, _ = torch.sort(ids, dim=-1)                            # (T, k)
    rows = mine * (c + 1) + slot[mine, torch.arange(t, device=dev)[:, None]]
    y_rows = torch.cat([y_e, y_e.new_zeros((n_experts, 1, d))], 1)
    contrib = y_rows.reshape(-1, d)[rows]                        # (T, k, D)
    out = contrib[:, 0] + 0.0
    for j in range(1, k):
        out = out + contrib[:, j]

    if "shared_wi" in params:
        out = out + swiglu(x, params["shared_wi"], params["shared_wg"],
                           params["shared_wo"], shared_tp).float()
    return out.to(PARAM_DTYPE), aux


# ===========================================================================
# expert-parallel moe: tokens move to the experts' shards and back
# ===========================================================================

def _ep_route(x_l: Tensor, router_w: Tensor, *, n_shards: int, e_local: int,
              k: int, capacity_factor: float):
    """One shard's routing: (x_send (S, C, D), meta (S, C, 2) f32 (each
    route's expert index on its shard and its gate, for the receiver),
    gate (S, C) f32, tok_send (S, C), aux). Each destination shard takes
    the top C of this shard's routes to it by routing weight (ties to the
    lower route, filler routes at weight 0)."""
    t_l = x_l.shape[0]
    weights, ids, aux = router_topk(x_l, router_w, k)
    r_ids, r_w = ids.reshape(-1), weights.reshape(-1)            # (T_l k,)
    r_tok = torch.arange(t_l, device=x_l.device).repeat_interleave(k)
    r_dst, r_eid = r_ids // e_local, r_ids % e_local
    c_send = min(int(max(1, (t_l * k * capacity_factor) // n_shards)),
                 t_l * k)
    dst = torch.arange(n_shards, device=x_l.device)[:, None]
    score = torch.where(r_dst[None, :] == dst, r_w[None, :],
                        torch.zeros((), device=x_l.device))      # (S, R)
    gate, sel = _top_k(score, c_send)                            # (S, C)
    tok_send = r_tok[sel]
    x_send = x_l[tok_send.reshape(-1)].reshape(n_shards, c_send, -1)
    meta = torch.stack([r_eid[sel].float(), gate.detach()], -1)
    return x_send, meta, gate, tok_send, aux


def _ep_experts(x_recv: Tensor, meta_recv: Tensor, wi: Tensor, wg: Tensor,
                wo: Tensor, *, capacity_factor: float, tp=None,
                tp_shards: int = 1) -> Tensor:
    """One shard's local experts over the routes it received (S, C, D):
    each expert takes up to C2 of its valid routes (the lower route
    first), the SwiGLU with an f32 down-projection weighted by the pick,
    and the results back in route order (S, C, D) bf16 (0 where a route
    was dropped).

    The reference's `has_tp` branch: tp is the model group over which
    wi/wg hold this rank's d_ff columns and wo its rows; the picked
    tokens enter through CopyToGroup, and the f32 partial product is
    rounded to bf16 and summed over the group (ReduceFromGroup: the
    reference's bf16 psum) before the pick weight. tp_shards > 1 runs the
    same with whole experts in one process: the d_ff blocks' partials
    summed in block order (moe_ffn_ep_emulated)."""
    s, c, d = x_recv.shape
    e_local, r_total = wi.shape[0], s * c
    xr = x_recv.reshape(r_total, d)
    er = meta_recv[..., 0].reshape(r_total).long()
    valid = (meta_recv[..., 1].reshape(r_total) > 0).float()
    c2 = min(int(max(1, (r_total * capacity_factor) // e_local)), r_total)
    experts = torch.arange(e_local, device=xr.device)[:, None]
    onehot = torch.where(er[None, :] == experts, valid[None, :],
                         torch.zeros((), device=xr.device))      # (E_l, R)
    pick_w, pick = _top_k(onehot, c2)                            # (E_l, C2)
    x_e = copy_to(xr[pick.reshape(-1)].reshape(e_local, c2, d), tp)

    def partial(x_e, wi, wg, wo):
        h = matmul(x_e, wi)
        g = matmul(x_e, wg)
        h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
        # the reference's f32 einsum (preferred_element_type) before the
        # pick
        return torch.matmul(h.float(), wo.float())

    if tp is not None:
        y_e = reduce_from(partial(x_e, wi, wg, wo).to(PARAM_DTYPE),
                          tp).float()
    elif tp_shards > 1:
        y_e = None
        blocks = zip(_Replicas.apply(x_e, tp_shards),
                     wi.chunk(tp_shards, -1), wg.chunk(tp_shards, -1),
                     wo.chunk(tp_shards, -2))
        for block in blocks:
            p = partial(*block).to(PARAM_DTYPE).float()
            y_e = p if y_e is None else y_e + p
        y_e = y_e.to(PARAM_DTYPE).float()
    else:
        y_e = partial(x_e, wi, wg, wo)
    y_e = (y_e * pick_w[..., None]).to(PARAM_DTYPE)
    # a route has one expert: at most one nonzero add a slot (fillers add
    # an exact 0), in pick order
    yr = torch.zeros((r_total, d), dtype=PARAM_DTYPE, device=xr.device)
    yr = yr.index_put((pick.reshape(-1),), y_e.reshape(-1, d),
                      accumulate=True)
    return yr.reshape(s, c, d)


class _Replicas(torch.autograd.Function):
    """n views of x whose grads are summed in f32 in order and rounded
    once to x's dtype: the model ranks' CopyToGroup of `_ep_experts`, in
    one process."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].float()
        for g in grads[1:]:
            total = total + g.float()
        return total.to(grads[0].dtype), None


def _ep_combine(y_back: Tensor, gate: Tensor, tok_send: Tensor, t_l: int
                ) -> Tensor:
    """The results back at their source shard (S, C, D), weighted by their
    gate in f32 and added into their tokens in route order (shard 0's
    routes first, as XLA's sequential scatter); bf16 (T_l, D)."""
    d = y_back.shape[-1]
    contrib = (y_back.float() * gate[..., None]).reshape(-1, d)
    out = torch.zeros((t_l, d), dtype=torch.float32, device=y_back.device)
    out = out.index_put((tok_send.reshape(-1),), contrib, accumulate=True)
    return out.to(PARAM_DTYPE)


def _shared(x: Tensor, params, out: Tensor, tp=None) -> Tensor:
    if "shared_wi" in params:
        out = out + swiglu(x, params["shared_wi"], params["shared_wg"],
                           params["shared_wo"], tp)
    return out


def moe_ffn_ep(x: Tensor, params, *, n_experts: int, k: int, group,
               capacity_factor: float = 1.25, tp=None, shared_tp=None
               ) -> Tuple[Tensor, Tensor]:
    """x: (T_l, D) this rank's tokens; params: the router and shared
    experts whole, wi/wg/wo this rank's block of the experts (E / n, ...),
    n = group.size (a dist.collectives.AxesGroup over the data axes).

    Returns (out (T_l, D) bf16, aux_share 0-d f32): aux_share is this
    rank's router aux over n, so its sum over the group is the
    reference's aux (the mean over shards), and the grads of every rank's
    share sum to the grad of that mean. Two all_to_alls carry the tokens
    (differentiable) and one the routes' expert ids and gates.

    tp: the model group where the experts' d_ff is split over it as well
    (the reference's `has_tp`: wi/wg (E / n, D, F / tp), wo (E / n, F /
    tp, D)); x, the routing and the exchanges are the same on every rank
    of it, and `_ep_experts` sums the partials over it. shared_tp: the
    same for the shared experts' d_ff (a dense row-parallel SwiGLU)."""
    n = group.size
    e_local = n_experts // n
    if n_experts % n or params["wi"].shape[0] != e_local:
        raise ValueError(f"moe_ffn_ep: {n_experts} experts over {n} ranks "
                         f"need a block of {n_experts // n} a rank, got "
                         f"{params['wi'].shape[0]}")
    from repro_torch.dist.collectives import AllToAll
    x_send, meta, gate, tok_send, aux = _ep_route(
        x, params["router"], n_shards=n, e_local=e_local, k=k,
        capacity_factor=capacity_factor)
    x_recv = AllToAll.apply(x_send, group)
    meta_recv = group.all_to_all(meta)
    y = _ep_experts(x_recv, meta_recv, params["wi"], params["wg"],
                    params["wo"], capacity_factor=capacity_factor, tp=tp)
    y_back = AllToAll.apply(y, group)
    out = _ep_combine(y_back, gate, tok_send, x.shape[0])
    return _shared(x, params, out, shared_tp), aux / n


def moe_ffn_ep_emulated(x: Tensor, params, *, n_experts: int, k: int,
                        n_shards: int, capacity_factor: float = 1.25,
                        tp_shards: int = 1) -> Tuple[Tensor, Tensor]:
    """moe_ffn_ep's world of `n_shards` ranks in one process: x (T, D) the
    ranks' tokens rank-major, params whole (every expert). The exchanges
    are tensor indexing; every stage runs on the same shapes as a rank's.
    tp_shards > 1 emulates the `has_tp` branch over that many model ranks:
    the experts' d_ff in as many blocks, their bf16 partials summed in
    block order (the shared experts stay whole). Returns (out (T, D)
    bf16, aux: the sum of the ranks' aux shares)."""
    e_local = n_experts // n_shards
    xs = x.chunk(n_shards)
    routes = [_ep_route(xl, params["router"], n_shards=n_shards,
                        e_local=e_local, k=k, capacity_factor=capacity_factor)
              for xl in xs]
    ys = []
    for j in range(n_shards):
        blk = slice(j * e_local, (j + 1) * e_local)
        ys.append(_ep_experts(
            torch.stack([r[0][j] for r in routes]),
            torch.stack([r[1][j] for r in routes]),
            params["wi"][blk], params["wg"][blk], params["wo"][blk],
            capacity_factor=capacity_factor, tp_shards=tp_shards))
    outs, aux = [], None
    for i, (_, _, gate, tok_send, a) in enumerate(routes):
        y_back = torch.stack([ys[j][i] for j in range(n_shards)])
        out = _ep_combine(y_back, gate, tok_send, xs[i].shape[0])
        outs.append(_shared(xs[i], params, out))
        aux = a / n_shards if aux is None else aux + a / n_shards
    return torch.cat(outs), aux
