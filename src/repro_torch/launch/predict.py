"""The dry-run's collective predictors: what one rank hands each of its
groups in one train step, from the configuration, the plan's specs and
the shapes alone — nothing is run.

  * `tp_collectives`: the calls and bytes over the model axis
    (tensor-parallel training under the reference plan, remat "full");
  * `fsdp_data_collectives`: the calls and bytes over the data axes
    under the FSDP plan.

A step's `AxesGroup.counts` must come true to them, call for call and
byte for byte: chip_smoke.py's phases 19 and 21 hold the counts of the
steps they run on the card, and tests/test_torch_dryrun.py holds
`analyze.census.census_step`'s counts of a step on an abstract mesh.
"""

from __future__ import annotations

import math

from repro_torch.dist import sharding
from repro_torch.launch.mesh import DATA_AXES, abstract_mesh
from repro_torch.models import moe
from repro_torch.models.registry import EP_MIN_TOKENS, build_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import step as step_lib


def tp_collectives(cfg, seq, batch, ranks, shape=None, fsdp=False):
    """(calls, bytes) one rank hands its model group in one train step of
    cfg over {"model": ranks} (no data axis; remat "full"), from the
    shapes; over the mesh `shape` with a data axis beside the model axis
    (phase 21) `batch` is the rows a rank holds and the optimizer's sums
    follow the plan's blocks there (FSDP with `fsdp`). Every sum runs in
    f32 (4 bytes an element); a gather hands over its input, a
    reduce-scatter the whole grad.

    A layer's forward sums (a row-parallel product's ReduceFromGroup, a
    GatherDim's all-gather) run once in the forward and again in remat's
    recompute, but for the layer's last where nothing after it saves a
    tensor for the backward (torch.utils.checkpoint's recompute stops once
    the tensors the backward saved are back): a last sum that only enters
    the residual add (attention's or the FFN's wo, whisper's bo added
    after it) is not recomputed; rwkv6's channel mix, whose sum the gate
    multiplies, is. Its backward sums run once: a CopyToGroup's input
    grad, a GatherDim's reduce-scatter. Per family:

      * dense and moe: attention (its k and v gathered whole, cut a rank,
        where the kv heads do not split) and the FFN; a moe layer's
        experts' (E, C, D) and shared experts' sums;
      * hybrid: attention whole on every rank where a rank holds part of a
        head (q, k and v gathered, reduce-scattered back), the mamba
        path's input, x_proj's partial (B, S, dt_rank + 2N) and its
        CopyToGroup, out_proj, the FFN;
      * ssm: the time mix's r, k, v, g inputs, the decay (B, S, D) f32 and
        ln_x (D) through CopyToGroup, tm/wo; the channel mix's k input
        and cm/wv;
      * encdec: the encoder's attention and FFN over B x enc_seq frames;
        the decoder's self- and cross-attention (and the encoder output's
        CopyToGroup a layer) and FFN;
      * vlm: the dense stack over vis + text.

    Where the vocab splits (even vocabs): the embedding's sum (B, S, D),
    and a loss chunk's max, sum of exponentials and target logit ((B,
    chunk) f32, forward and recompute) and its input's grad sum ((B,
    chunk, D)). The optimizer: the global norm's sum of the split leaves'
    squares; Adafactor also sums, for a leaf split on its last dim, its
    row means (the leaf's shape but the last dim) and for one split on
    the second-last its column means and its row factor's mean, and each
    split leaf's update RMS (a scalar)."""
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: the count assumes 'full'")
    shape = shape or {"model": ranks}
    d, t = cfg.d_model, batch * seq
    # the capacity route of a moe layer gathers the global batch's tokens
    # over the data axes (registry._moe_apply)
    t_moe = t * math.prod(shape[a] for a in DATA_AXES if a in shape)
    act = t * d * 4
    calls = nbytes = 0

    def add(n, size):
        nonlocal calls, nbytes
        calls += n
        nbytes += n * size

    def layer(fwd, bwd, last_saved=False):
        """A layer's forward sums (in order) and backward sums."""
        for size in fwd:
            add(1, size)
        for size in fwd[:len(fwd) - 1 + last_saved]:
            add(1, size)                          # the remat recompute
        for size in bwd:
            add(1, size)

    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        n_moe = cfg.n_layers - cfg.first_k_dense if fam == "moe" else 0
        for i in range(cfg.n_layers):
            fwd, bwd = [act], [act]               # attention
            if kvh % ranks:                       # whole k, v cut a rank
                bwd += [t * kvh * hd * 4] * 2
            last_saved = False
            if i < cfg.n_layers - n_moe:
                fwd.append(act)                   # the dense FFN
                bwd.append(act)
            else:
                e, k = cfg.n_experts, cfg.experts_per_token
                if t_moe >= EP_MIN_TOKENS:        # moe_ffn_ep, one data rank
                    if t_moe != t:
                        raise NotImplementedError(
                            "the expert-parallel route beside data ranks")
                    c_send = min(int(max(1, t * k * 1.25)), t * k)
                    c = min(int(max(1, (c_send * 1.25) // e)), c_send)
                else:
                    c = moe.capacity(t_moe, k, e)
                fwd.append(e * c * d * 4)         # the experts' sum
                bwd.append(e * c * d * 4)
                # the experts' sum is weighted (saved) unless the shared
                # experts' follows it
                last_saved = not cfg.n_shared_experts
                if cfg.n_shared_experts:          # the shared experts
                    fwd.append(t_moe * d * 4)
                    bwd.append(t_moe * d * 4)
            layer(fwd, bwd, last_saved)
    elif fam == "hybrid":
        proj = t * (max(1, d // 16) + 2 * cfg.ssm_state) * 4
        for _ in range(cfg.n_layers):
            fwd, bwd = [], [act, act, proj, act]  # attention, mamba, FFN in
            q_cols, kv_cols = h * hd // ranks, kvh * hd // ranks
            if q_cols % hd:                       # part of a head a rank
                fwd += [t * q_cols * 2, t * kv_cols * 2, t * kv_cols * 2]
                bwd += [t * h * hd * 2, t * kvh * hd * 2, t * kvh * hd * 2]
            fwd += [act, proj, act, act]          # attention, x_proj,
            layer(fwd, bwd)                       # out_proj, the FFN
    elif fam == "ssm":
        for _ in range(cfg.n_layers):
            # r, k, v, g inputs, the decay, ln_x; the channel mix's k input
            layer([act, act], [act] * 5 + [d * 4, act], last_saved=True)
    elif fam == "encdec":
        frames = batch * cfg.enc_seq * d * 4
        for _ in range(cfg.n_enc_layers):
            layer([frames, frames], [frames, frames])
        for _ in range(cfg.n_layers):
            # self-attention, cross-attention (and the encoder output's
            # input grad), the FFN
            layer([act, act, act], [act, act, frames, act])
    else:
        raise ValueError(f"family {fam!r}")
    if cfg.vocab_size % ranks == 0:
        text = seq - (cfg.n_vis_tokens if fam == "vlm" else 0)
        add(1, act)                               # the embedding
        chunk = next((c for c in (512, 256, 128, 64) if text % c == 0
                      and text > c), text)
        for _ in range(text // chunk):
            # the three sums, again in the checkpoint's recompute where
            # the loss runs in chunks
            add(6 if chunk < text else 3, batch * chunk * 4)
            add(1, batch * chunk * d * 4)
    mesh = abstract_mesh(shape)
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train", fsdp=fsdp)
    ab = model.abstract_params()
    specs = sharding.params_shardings(plan, model.param_axes, ab)
    mdims = tree_leaves(sharding.model_dims(plan, specs))
    split = sum(m is not None for m in mdims)
    add(1, split * 4)                             # the global norm
    if cfg.optimizer == "adafactor":
        for leaf, spec, m in zip(tree_leaves(ab), tree_leaves(specs), mdims):
            if m is None:
                continue
            shape = sharding.local_shape(tuple(leaf.shape), spec, mesh)
            nd = len(shape)
            if nd >= 2 and m == nd - 1:           # vr's row means
                add(1, math.prod(shape[:-1]) * 4)
            elif nd >= 2 and m == nd - 2:         # vc's means, rfac's
                add(1, math.prod(shape[:-2] + shape[-1:]) * 4)
                add(1, math.prod(shape[:-2]) * 4)
            add(1, 4)                             # the update's RMS
    return calls, nbytes


def _paths(tree, pre=""):
    """The leaves' paths ("layers/moe/wi") in tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{pre}/{k}" if pre else k)]
    return [pre]


def fsdp_data_collectives(cfg, shape, seq=None, batch=None):
    """(calls, bytes) one rank hands its data group in one train step of
    cfg under the FSDP plan over `shape`, from the specs: each split
    leaf's all_gather before the forward (its block, in the param's
    dtype) and reduce-scatter after (the gathered grad in f32), each
    whole leaf's grad all-reduced in f32; the loss's token count and the
    metrics' three sums; the global norm's sum of the split leaves'
    squares; Adafactor's row means (a leaf split on its last dim), column
    means and row factor's mean (split on the second-last) and each split
    leaf's update RMS.

    A moe model's experts split over the data axes (the plan's ep_data)
    are no FSDP leaves: their grads stay local, and each moe layer's
    capacity route (registry._moe_apply; the global batch's tokens below
    EP_MIN_TOKENS) gathers the layer's wi, wg and wo blocks and the
    rank's `batch` x `seq` tokens (bf16) in the forward and again in
    remat's recompute, and reduce-scatters their grads in the backward."""
    mesh = abstract_mesh(shape)
    model = build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train", fsdp=True)
    ab = model.abstract_params()
    specs = sharding.params_shardings(plan, model.param_axes, ab,
                                      model.param_parts)
    dims = tree_leaves(sharding.data_dims(plan, specs))
    n_dp = plan.dp_size()
    calls = nbytes = 0

    def add(n, size):
        nonlocal calls, nbytes
        calls += n
        nbytes += n * size

    route = 0                                     # a moe layer's gathers
    for path, leaf, spec, d in zip(_paths(ab), tree_leaves(ab),
                                   tree_leaves(specs), dims):
        local = sharding.local_shape(tuple(leaf.shape), spec, mesh)
        n = math.prod(local)
        if d is None:
            add(1, n * 4)                         # the grad's all_reduce
            continue
        axes = model.param_axes.get(path) or ()
        if plan.ep_data and d < len(axes) and axes[d] == "experts":
            route += n // local[0] * leaf.element_size()    # a layer's
        else:
            add(1, n * leaf.element_size())       # the forward's gather
            add(1, n * n_dp * 4)                  # the grad's reduce-scatter
        if cfg.optimizer == "adafactor":
            nd = len(local)
            if nd >= 2 and d == nd - 1:           # vr's row means
                add(1, math.prod(local[:-1]) * 4)
            elif nd >= 2 and d == nd - 2:         # vc's means, rfac's
                add(1, math.prod(local[:-2] + local[-1:]) * 4)
                add(1, math.prod(local[:-2]) * 4)
            add(1, 4)                             # the update's RMS
    if route:
        if seq is None or batch is None:
            raise ValueError("a moe plan's data collectives need seq= and "
                             "batch= (the rows a rank holds)")
        t = batch * seq
        if t * n_dp >= EP_MIN_TOKENS:
            raise NotImplementedError(
                "the expert-parallel route beside data ranks")
        tokens = t * cfg.d_model * 2
        for _ in range(cfg.n_layers - cfg.first_k_dense):
            # wi, wg, wo and the tokens: 4 gathers in the forward and 4 in
            # the recompute, 4 reduce-scatters of the gathered grads
            calls += 12
            nbytes += (2 + n_dp) * (route + tokens)
    add(1, 4)                                     # the loss's token count
    add(1, 3 * 4)                                 # loss, aux, total
    split = sum(d is not None for d in dims)
    if split:
        add(1, split * 4)                         # the global norm
    return calls, nbytes
