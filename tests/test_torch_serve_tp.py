"""Tensor-parallel serving in the port: ServeEngine(mesh=) over a 2-rank
gloo world on the CPU (tests/_torch_tp_worker.py: one process a rank,
a FileStore rendezvous, a timeout on every rank) held bit for bit to the
port's unsharded engine, which tests/test_torch_serve*.py hold to the
JAX engine (the JAX package's own sharded-engine tests fail on this jax,
ROADMAP queue 3). Exact-TP: weights split on their output dims only,
every cross-rank combine a concatenation, so tokens and every model
call's logits are equal, greedy and sampled, on the local-heads route
(qwen2's 12 q / 2 kv heads, deepseek's 8 / 8 at this size) and on the
whole-heads gather route (1 kv head over 2 ranks: a wk shard holds half
a head). Also: the 1-rank mesh, the Router at TP 2, flash_decode_sharded
against JAX's decode_attention, the seq-sharded decode cache, the
refusals, and the CPU's column-block products."""

import numpy as np
import pytest
import torch

import _torch_tp_worker as W

# reduced configs at the sizes the reference's own sharded test uses
DENSE = dict(arch="qwen2-1.5b", reduce=dict(layers=2, d_model=384,
                                             vocab=128),
             replace=dict(use_flash_attention=True), seed=0)
DENSE_GATHER = dict(arch="qwen2-1.5b", reduce=dict(layers=2, d_model=256,
                                                    vocab=128),
                    replace=dict(use_flash_attention=True), seed=2)
MOE = dict(arch="deepseek-moe-16b", reduce=dict(layers=2, d_model=256,
                                                 vocab=128),
           replace=dict(use_flash_attention=True), seed=1)
# five requests over 2 slots, greedy and T=0.7 mixed; one 256-token
# prompt takes the flash route (its plain version on the CPU)
REQS = dict(lens=(5, 9, 256, 12, 7), seed=3, temps=(0.0, 0.7),
            max_new=(9, 3))


def _serve(cfg):
    return dict(cfg, max_batch=2, cache_len=288, requests=REQS)


def _flash_inputs(seed, clen):
    rng = np.random.default_rng(seed)
    b, h, kvh, hd, lc = 4, 8, 2, 64, 256

    def bf16(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    return dict(q=bf16((b, 1, h, hd)), k=bf16((b, lc, kvh, hd)),
                v=bf16((b, lc, kvh, hd)), cache_len=clen)


FLASH_CASES = {"flash_decode:200": _flash_inputs(0, 200),
               # rank 1's half holds no valid position at all
               "flash_decode:100": _flash_inputs(1, 100),
               "flash_decode:w": dict(_flash_inputs(2, 240), window=64)}
SEQ_DECODE = dict(arch="qwen2-1.5b", reduce=dict(layers=1, d_model=384,
                                                  vocab=128),
                  seed=4, batch=2, cache_len=16, steps=12)
ROUTER = dict(DENSE, replace={},
              trace=dict(n_requests=8, rate_rps=40.0, out_max=8,
                         prompt_max=12, seed=11))

WORLD_CASES = ([("serve:dense", _serve(DENSE)),
                ("serve:gather", _serve(DENSE_GATHER)),
                ("serve:moe", _serve(MOE)),
                ("router", ROUTER),
                ("seq_shard_decode", SEQ_DECODE),
                ("mesh2d", None)]
               + list(FLASH_CASES.items()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on both ranks of one 2-rank world (one spawn)."""
    return W.run_world(tmp_path_factory.mktemp("tp2"), 2, WORLD_CASES)


def _assert_served_like_one_device(world, name, payload):
    ref = W.serve(None, payload)
    for rank in (0, 1):
        got = world[rank][name]
        assert got["tokens"] == ref["tokens"], (rank, got["tokens"],
                                                ref["tokens"])
        assert len(got["logits"]) == len(ref["logits"])
        for i, (a, b) in enumerate(zip(got["logits"], ref["logits"])):
            assert torch.equal(a, b), (rank, i, float((a - b).abs().max()))
    assert world[0][name]["tokens"] == world[1][name]["tokens"]
    return ref


def test_tp2_dense_local_heads_bitexact(world):
    """qwen2 (12 q, 2 kv heads: 6 and 1 a rank) at TP 2: tokens and every
    model call's logits bit-equal to the unsharded engine on both ranks;
    the weights really split (wq, wk, wv, their biases, wi, wg)."""
    _assert_served_like_one_device(world, "serve:dense", _serve(DENSE))
    shapes = world[0]["serve:dense"]["shapes"]
    split = sorted(k.split("/")[-1] for k, (loc, whole) in shapes.items()
                   if loc != whole)
    assert split == ["bk", "bq", "bv", "wg", "wi", "wk", "wq", "wv"]
    assert shapes["layers/attn/wk"] == ((2, 384, 32), (2, 384, 64))
    assert shapes["layers/attn/wo"][0] == shapes["layers/attn/wo"][1]


def test_tp2_dense_whole_head_gather_bitexact(world):
    """1 kv head over 2 ranks: wk's shard is half a head, so q, k and v
    are gathered to whole heads right after the projections; still
    bit-equal."""
    _assert_served_like_one_device(world, "serve:gather",
                                   _serve(DENSE_GATHER))
    shapes = world[1]["serve:gather"]["shapes"]
    assert shapes["layers/attn/wk"] == ((2, 256, 16), (2, 256, 32))


def test_tp2_moe_bitexact(world):
    """deepseek (moe, untied head: the vocab-split logits gathered) at TP
    2: bit-equal; the experts' and shared experts' up-projections split."""
    _assert_served_like_one_device(world, "serve:moe", _serve(MOE))
    shapes = world[0]["serve:moe"]["shapes"]
    for leaf in ("layers/moe/wi", "layers/moe/wg", "layers/moe/shared_wi",
                 "head", "dense_layers/ffn/wi"):
        loc, whole = shapes[leaf]
        assert loc[-1] * 2 == whole[-1], leaf
    assert shapes["layers/moe/wo"][0] == shapes["layers/moe/wo"][1]
    assert shapes["layers/moe/router"][0] == shapes["layers/moe/router"][1]


def test_tp2_device_stats(world):
    """device_stats: one entry a rank, gathered (the same list on both),
    each rank's param bytes below the whole tree's; last_stats carries
    devices and per_device."""
    a, b = (world[r]["serve:dense"] for r in (0, 1))
    assert a["device_stats"] == b["device_stats"]
    assert [d["device"] for d in a["device_stats"]] == [0, 1]
    whole = sum(2 * np.prod(w) for _, w in a["shapes"].values())
    for d in a["device_stats"]:
        assert 0 < d["params_bytes"] < whole and d["cache_bytes"] > 0
    assert a["engine"]["devices"] == 2
    assert [d["params_bytes"] for d in a["engine"]["per_device"]] == \
        [d["params_bytes"] for d in a["device_stats"]]
    assert a["engine"]["per_device"][0]["occupancy"] == \
        a["engine"]["occupancy"]


def test_one_rank_mesh_bitexact_and_device_stats():
    """A mesh of one rank (no process group) is the mesh-less engine: the
    same tokens and logits, and one device_stats entry."""
    from repro_torch.launch.mesh import make_mesh
    payload = _serve(dict(DENSE, reduce=dict(layers=2, d_model=64,
                                             vocab=128)))
    ref = W.serve(None, payload)
    got = W.serve(make_mesh({"model": 1}, device="cpu", backend="gloo"),
                  payload)
    assert got["tokens"] == ref["tokens"]
    assert all(torch.equal(a, b) for a, b in zip(got["logits"],
                                                  ref["logits"]))
    assert len(got["device_stats"]) == 1 and got["engine"]["devices"] == 1
    whole = sum(2 * np.prod(w) for _, w in got["shapes"].values())
    assert got["device_stats"][0]["params_bytes"] == whole


def test_router_tp2_bitexact(world):
    """Two replicas, each TP 2 over the same world, with a flap: the same
    outputs and outcomes as the Router without a mesh."""
    ref = W.router(None, ROUTER)
    for rank in (0, 1):
        got = world[rank]["router"]
        assert got["tokens"] == ref["tokens"]
        assert (got["completed"], got["recoveries"], got["outcomes"]) == \
            (ref["completed"], ref["recoveries"], ref["outcomes"])
    assert ref["completed"] == ROUTER["trace"]["n_requests"]


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_decode_sharded_matches_reference(world, name):
    """flash_decode_sharded with the cache's seq dim over 2 ranks, within
    the reference's 5e-3 of JAX's decode_attention on the same inputs
    (and of the port's), the same on both ranks."""
    import jax.numpy as jnp
    from repro.models.attention import decode_attention as jax_decode
    from repro_torch.models.attention import decode_attention
    p = FLASH_CASES[name]
    want = np.asarray(jax_decode(
        *(jnp.asarray(p[x], jnp.bfloat16) for x in "qkv"),
        jnp.int32(p["cache_len"]), window=p.get("window", 0)).astype(
            jnp.float32))
    port = decode_attention(*(torch.from_numpy(p[x]).to(torch.bfloat16)
                              for x in "qkv"), p["cache_len"],
                            window=p.get("window", 0)).float()
    assert torch.equal(world[0][name], world[1][name])
    got = world[0][name].numpy()
    assert np.abs(got - want).max() < 5e-3
    assert np.abs(got - port.numpy()).max() < 5e-3


def test_seq_sharded_decode_cache(world):
    """attn_block_decode with ctx.kv_seq_shard (lockstep pos, the cache's
    seq dim over 2 ranks): each line written once, by the rank holding it
    (the ranks' blocks concatenate to the unsharded cache, bit-equal), and
    every step within 5e-3 of the unsharded decode."""
    ref = W.seq_shard_decode(None, SEQ_DECODE)
    for key in ("k", "v"):
        whole = torch.cat([world[r]["seq_shard_decode"][key]
                           for r in (0, 1)], dim=1)
        assert torch.equal(whole, ref[key])
    for rank in (0, 1):
        for a, b in zip(world[rank]["seq_shard_decode"]["outs"],
                        ref["outs"]):
            assert float((a - b).abs().max()) < 5e-3


def test_two_axis_mesh_groups(world):
    """make_mesh's DeviceMesh route over a running world: ("data", "model")
    of 1 x 2, rank-major coords, the model axis's group over both ranks
    (an all_reduce over it sums 1 + 2), no group on the axis of 1."""
    for rank in (0, 1):
        got = world[rank]["mesh2d"]
        assert got["coords"] == {"data": 0, "model": rank}
        assert got["ranks"] == [0, 1] and got["sum"] == 3.0
        assert got["group"] is None


def test_paged_and_spec_refuse_mesh():
    """As in the JAX engine: a paged or speculative engine refuses mesh=."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeEngine
    cfg, params = W.build("qwen2-1.5b", dict(layers=1, d_model=64,
                                             vocab=128), {}, 0)
    mesh = make_mesh({"model": 1}, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="paged K/V cache"):
        ServeEngine(cfg, params, device="cpu", mesh=mesh, kv_page_size=16)
    with pytest.raises(ValueError, match="speculative decoding"):
        ServeEngine(cfg, params, device="cpu", mesh=mesh, spec_k=2,
                    draft_cfg=cfg, draft_params=params)


@pytest.mark.parametrize("arch", ("hymba-1.5b", "rwkv6-7b", "whisper-small",
                                  "internvl2-26b"))
def test_other_families_refuse_mesh(arch):
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ServeEngine
    cfg = reduce_config(get_config(arch), layers=1, d_model=64, vocab=128)
    mesh = make_mesh({"model": 1}, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="item 9.3"):
        ServeEngine(cfg, {}, device="cpu", mesh=mesh)


@pytest.mark.parametrize("m", (1, 2, 4, 64))
def test_cpu_column_block_products_bitexact(m):
    """The exact-TP contract at the op: inside exact_tp_scope a column
    block of layers.matmul, of the untied head's lm_logits(blocked=True)
    and of the expert bmm equals the same columns of the whole product, at
    the test widths and at qwen2's K = 1536, where the CPU contracts in
    K_BLOCK blocks."""
    from repro_torch.models.layers import exact_tp_scope, lm_logits, matmul

    def head(x, w):
        return lm_logits(x, w, blocked=True)

    gen = torch.Generator().manual_seed(m)
    with exact_tp_scope(None):
        for k, n in ((384, 1152), (1536, 1536), (1536, 8960)):
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
            w = torch.randn(k, n, generator=gen).to(torch.bfloat16)
            for fn in (matmul, head):
                whole = fn(x, w)
                for tp in (2, 4):
                    nl = n // tp
                    for r in range(tp):
                        part = fn(x, w[:, r * nl:(r + 1) * nl].contiguous())
                        assert torch.equal(part,
                                           whole[:, r * nl:(r + 1) * nl]), \
                            (fn.__name__, k, n, tp, r)
        xe = torch.randn(4, m, 512, generator=gen).to(torch.bfloat16)
        we = torch.randn(4, 512, 256, generator=gen).to(torch.bfloat16)
        whole = matmul(xe, we)
        assert torch.equal(matmul(xe, we[..., 128:].contiguous()),
                           whole[..., 128:])


def test_products_outside_the_scope_are_one_product():
    """Outside exact_tp_scope (training, the families that serve without a
    mesh) matmul and lm_logits are one f32 product each, as before the
    mesh existed; inside it the CPU's matmul and the blocked head contract
    in K blocks."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(3, 1536, generator=gen).to(torch.bfloat16)
    w = torch.randn(1536, 640, generator=gen).to(torch.bfloat16)
    one = torch.matmul(x.float(), w.float())
    assert not layers.in_exact_tp()
    assert torch.equal(layers.matmul(x, w), one.to(torch.bfloat16))
    assert torch.equal(layers.lm_logits(x, w), one)
    blocked = layers._blocked_product(x, w)
    with layers.exact_tp_scope(None):
        assert layers.in_exact_tp()
        assert torch.equal(layers.matmul(x, w), blocked.to(torch.bfloat16))
        assert torch.equal(layers.lm_logits(x, w), one)
        assert torch.equal(layers.lm_logits(x, w, blocked=True), blocked)
    assert not layers.in_exact_tp()


@pytest.mark.parametrize("arch, scoped", [("qwen2-1.5b", True),
                                          ("deepseek-moe-16b", True),
                                          ("rwkv6-7b", False)])
def test_engine_scope_by_family(arch, scoped):
    """A dense or moe engine runs its model calls in exact_tp_scope even
    without a mesh (the order a sharded engine is held to); the families
    that serve under no mesh do not."""
    import dataclasses
    from repro_torch.models import layers
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = W.build(arch, dict(layers=2, d_model=64, vocab=128), {}, 0)
    eng = ServeEngine(cfg, params, max_batch=1, cache_len=32, device="cpu")
    seen = []

    def spy(fn):
        def call(*a, **kw):
            seen.append(layers.in_exact_tp())
            return fn(*a, **kw)
        return call

    eng.model = dataclasses.replace(
        eng.model, decode_step=spy(eng.model.decode_step),
        prefill_into_slot=spy(eng.model.prefill_into_slot))
    eng.run([Request(rid=0, prompt=np.arange(5), max_new_tokens=3)])
    assert seen and all(s == scoped for s in seen), seen


@pytest.mark.parametrize("kvh, tp, r", [(2, 2, 0), (2, 2, 1), (4, 2, 1),
                                        (4, 4, 3)])
def test_rank_heads_inside_whole_products(kvh, tp, r):
    """heads=(first, total): rank r's kv heads of tp computed inside the
    whole head count's products (zeros at the other heads) are the same
    heads of the whole computation, decode (per-row lengths) and
    chunked (GQA groups of 3)."""
    from repro_torch.models.attention import (chunked_causal_attention,
                                              decode_attention)
    gen = torch.Generator().manual_seed(kvh + r)
    n, g, hd = kvh // tp, 3, 32

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    def mine(t, per):
        return t[:, :, r * per:(r + 1) * per].contiguous()

    q, k, v = rnd(2, 1, g * kvh, hd), rnd(2, 40, kvh, hd), rnd(2, 40, kvh,
                                                             hd)
    clen = torch.tensor([40, 17])
    whole = decode_attention(q, k, v, clen)
    got = decode_attention(mine(q, n * g), mine(k, n), mine(v, n), clen,
                           heads=(r * n, kvh))
    assert torch.equal(got, mine(whole, n * g))
    q, k, v = rnd(1, 24, g * kvh, hd), rnd(1, 24, kvh, hd), rnd(1, 24, kvh,
                                                              hd)
    whole = chunked_causal_attention(q, k, v, chunk=8)
    got = chunked_causal_attention(mine(q, n * g), mine(k, n), mine(v, n),
                                   chunk=8, heads=(r * n, kvh))
    assert torch.equal(got, mine(whole, n * g))


def test_make_mesh_checks():
    """make_mesh names its axes, checks the backend and the world, and a
    1-rank mesh needs no process group."""
    from repro_torch.launch.mesh import Mesh, make_debug_mesh, make_mesh
    m = make_mesh((1, 1), ("data", "model"), device="cpu", backend="gloo")
    assert m.shape == {"data": 1, "model": 1} and m.group("model") is None
    assert make_debug_mesh(1, 1, device="cpu", backend="nccl").size == 1
    with pytest.raises(ValueError, match="backend"):
        make_mesh({"model": 1}, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="init_method"):
        make_mesh({"model": 2}, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="one name each"):
        make_mesh((2, 2), ("model",), device="cpu", backend="gloo")
    assert Mesh({"pod": 2, "data": 2, "model": 2}, rank=5, device="cpu",
                backend="gloo").coords == {"pod": 1, "data": 0, "model": 1}
