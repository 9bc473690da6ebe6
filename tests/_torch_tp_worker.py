"""Rank processes for tests/test_torch_serve_tp.py: a gloo world on the
CPU, one process a rank, each importing torch and repro_torch only (no
jax, so a rank starts in a few seconds).

`run_world(tmp_path, n, cases)` spawns n ranks that rendezvous through a
FileStore under tmp_path (no port to collide over between xdist
workers), runs every (name, payload) of `cases` on each rank in order,
and returns {rank: {name: result}}. The mesh is {"model": n} unless
`shape` names another; `module` names the module whose CASES the ranks
run (this one by default; tests/_torch_dp_worker.py for training). Every
rank, and the world (`timeout_s`, WORLD_TIMEOUT_S by default), has a
timeout: a hung rendezvous or collective fails the test instead of
hanging it, and a rank that raises fails it with the rank's traceback.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

WORLD_TIMEOUT_S = 240.0
COLLECTIVE_TIMEOUT_S = 120.0


def run_world(tmp_path, n: int, cases: List[Tuple[str, Any]],
              device: str = "cpu", shape: Optional[Dict[str, int]] = None,
              module: str = "_torch_tp_worker",
              timeout_s: float = WORLD_TIMEOUT_S
              ) -> Dict[int, Dict[str, Any]]:
    import torch.multiprocessing as mp
    store = os.path.join(str(tmp_path), "store")
    out = os.path.join(str(tmp_path), "out")
    os.makedirs(out, exist_ok=True)
    shape = {"model": n} if shape is None else shape
    ctx = mp.start_processes(_rank_main,
                             args=(n, store, out, cases, device, shape,
                                   module),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"the {n}-rank world ran past "
                               f"{timeout_s} s")
    return {r: torch.load(os.path.join(out, f"rank{r}.pt"),
                          weights_only=False) for r in range(n)}


def _rank_main(rank, n, store, out, cases, device, shape, module):
    import importlib

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    if device.startswith("cuda"):
        torch.cuda.set_device(0)       # every rank on the one card
    mesh = make_mesh(shape, device=device, backend="gloo",
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=COLLECTIVE_TIMEOUT_S)
    table = importlib.import_module(module).CASES
    results = {name: table[name.split(":")[0]](mesh, payload)
               for name, payload in cases}
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# what a rank runs (each also runs in the test process without a mesh)
# ---------------------------------------------------------------------------

def build(arch: str, reduce: Dict, replace: Dict, seed: int):
    """The reduced config and its whole params from `seed` on the CPU: the
    same on every rank and in the test process."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduce_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduce_config(get_config(arch), **reduce),
                              **replace)
    return cfg, build_model(cfg).init_params(seed, device="cpu")


def requests(cfg, lens, seed: int, temps, max_new):
    """One request a prompt length, greedy and sampled in turn; an encdec
    request carries its own frames (bf16 and f32 in turn: f32 frames keep
    whisper's encoder stream in f32), a vlm request its own patch
    embeddings, drawn from `seed`."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    gen = torch.Generator().manual_seed(seed)

    def extra(i):
        if cfg.family == "encdec":
            f = torch.randn(1, cfg.enc_seq, cfg.d_model, generator=gen)
            return {"frames": (f * 0.5).to(torch.bfloat16 if i % 2 == 0
                                            else torch.float32)}
        if cfg.family == "vlm":
            return {"vis": torch.randn(1, cfg.n_vis_tokens, cfg.d_model,
                                       generator=gen).to(torch.bfloat16)}
        return None

    return [Request(rid=i, prompt=p, max_new_tokens=max_new[i % len(max_new)],
                    temperature=temps[i % len(temps)], extra=extra(i))
            for i, p in enumerate(prompts)]


def serve(mesh, payload):
    """Serve payload's requests through ServeEngine (over `mesh` when it
    is not None); record every model call's logits in call order. Returns
    tokens, logits, device_stats, each param leaf's (local, whole) shape,
    and the last_stats' devices/per_device."""
    import dataclasses
    from repro_torch.serve.engine import ServeEngine
    cfg, params = build(payload["arch"], payload["reduce"],
                        payload["replace"], payload["seed"])
    eng = ServeEngine(cfg, params, max_batch=payload["max_batch"],
                      cache_len=payload["cache_len"],
                      device=payload.get("device", "cpu"), mesh=mesh)
    logits = []

    def record(fn):
        def call(*a, **kw):
            lg, cache = fn(*a, **kw)
            logits.append(lg.float().cpu())
            return lg, cache
        return call

    eng.model = dataclasses.replace(
        eng.model, decode_step=record(eng.model.decode_step),
        prefill_into_slot=record(eng.model.prefill_into_slot))
    with _scan_calls() as scans:
        out, stats = eng.run(requests(cfg, **payload["requests"]),
                             collect_stats=True)
    whole = _shapes(params)
    local = _shapes(eng.params)
    return {"tokens": out, "logits": logits, "scans": scans,
            "shapes": {k: (local[k], whole[k]) for k in whole},
            "device_stats": eng.device_stats(),
            "engine": {k: stats["engine"].get(k) for k in
                       ("devices", "per_device", "occupancy")}}


@contextlib.contextmanager
def _scan_calls():
    """While open, every call of the selective-scan wrapper
    (kernels/ssm/ssm_cuda.ssm_scan: the kernel on the card, its plain
    version here) records (C, blk_c, states, device type)."""
    from repro_torch.kernels.ssm import ssm_cuda
    real = ssm_cuda.ssm_scan
    calls = []

    class Note:
        # the wrapper counts through its module-level name: forward it
        @property
        def launches(self):
            return real.launches

        @launches.setter
        def launches(self, n):
            real.launches = n

        def __call__(self, *args):
            calls.append((args[0].shape[2], args[7].blk_c, args[7].states,
                          args[0].device.type))
            return real(*args)

    ssm_cuda.ssm_scan = Note()
    try:
        yield calls
    finally:
        ssm_cuda.ssm_scan = real


def router(mesh, payload):
    """A 2-replica Router over payload's trace (each replica over `mesh`
    when it is not None); outputs and outcomes."""
    from repro_torch.serve.router import FaultPlan, Router
    from repro_torch.serve.trace import TraceConfig, generate_trace
    cfg, params = build(payload["arch"], payload["reduce"],
                        payload["replace"], payload["seed"])
    r = Router(cfg, params, replicas=2, max_batch=2, cache_len=64,
               device="cpu", mesh=mesh,
               fault_plan=FaultPlan().flap(1, at_tick=3, down_ticks=4))
    out, st = r.run(generate_trace(TraceConfig(**payload["trace"])))
    return {"tokens": out, "completed": st["completed"],
            "recoveries": st["recoveries"], "outcomes": st["outcomes"]}


def flash_decode(mesh, payload):
    """flash_decode_sharded on this rank's seq block of payload's whole
    caches (numpy); the combined output, the same on every rank."""
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models.attention import flash_decode_sharded
    from repro_torch.models.convert import tensor_from_numpy
    from repro_torch.models.layers import DistCtx
    # f32 arrays of bf16 values: exact in bf16
    q, k, v = (tensor_from_numpy(payload[x], "cpu").to(torch.bfloat16)
               for x in "qkv")
    spec = (None, "model", None, None)
    ctx = DistCtx(mesh=mesh, kv_seq_shard=True)
    out = flash_decode_sharded(q, local_shard(k, spec, mesh),
                               local_shard(v, spec, mesh),
                               payload["cache_len"], ctx=ctx,
                               window=payload.get("window", 0))
    return out.float()


def seq_shard_decode(mesh, payload):
    """Lockstep decode steps of one attention layer whose cache's seq dim
    is split over the model axis (ctx.kv_seq_shard, whole weights): each
    step's output, and this rank's cache block at the end."""
    from repro_torch.dist.sharding import local_shard
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import DistCtx
    cfg, params = build(payload["arch"], payload["reduce"], {},
                        payload["seed"])
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    b, lc = payload["batch"], payload["cache_len"]
    kv = torch.zeros(b, lc, cfg.n_kv_heads, cfg.head_dim,
                     dtype=torch.bfloat16)
    ctx = None
    if mesh is not None:
        kv = local_shard(kv, (None, "model", None, None), mesh)
        ctx = DistCtx(mesh=mesh, kv_seq_shard=True)
    ck, cv = kv.clone(), kv.clone()
    gen = torch.Generator().manual_seed(payload["seed"])
    outs = []
    for pos in range(payload["steps"]):
        x = (torch.randn(b, 1, cfg.d_model, generator=gen) * 0.5).to(
            torch.bfloat16)
        with torch.no_grad():
            o, _ = T.attn_block_decode(lp, x, cfg, cache_k=ck, cache_v=cv,
                                       pos=torch.tensor(pos), ctx=ctx)
        outs.append(o.float())
    return {"outs": outs, "k": ck, "v": cv}


def mesh2d(mesh, payload):
    """A ("data", "model") mesh of 1 x n over the world already running:
    the DeviceMesh route of make_mesh; this rank's coords, its model
    group's ranks, and an all_reduce over that group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh({"data": 1, "model": mesh.size}, device="cpu",
                  backend="gloo")
    group = m.group("model")
    t = torch.tensor([float(m.rank + 1)])
    dist.all_reduce(t, group=group)
    return {"coords": m.coords, "group": m.group("data"),
            "ranks": dist.get_process_group_ranks(group), "sum": float(t)}


def mamba_op(mesh, payload):
    """mamba_path on this rank's channels (hymba's layer 0, whole params
    from payload's seed): a prefill of payload["t"] tokens and one decode
    step from its states, under exact_tp_scope over `mesh` (None: one
    device). in_proj is cut as the engine cuts it (its block of xs beside
    its block of z) and, as the naive rank-major block (rank 0 all of xs,
    rank 1 all of z), for the prefill only. Returns the outputs and the
    conv and h states."""
    from repro_torch.dist import sharding
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import DistCtx, exact_tp_scope
    from repro_torch.models.registry import build_model
    cfg, params = build(payload["arch"], payload["reduce"],
                        payload["replace"], payload["seed"])
    whole = {k: v[0] for k, v in params["layers"]["mamba"].items()}
    gen = torch.Generator().manual_seed(payload["seed"])
    x = torch.randn(1, payload["t"], cfg.d_model, generator=gen).to(
        torch.bfloat16)
    xd = torch.randn(1, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    ctx, lp, naive, columns = None, whole, None, {}
    if mesh is not None:
        model = build_model(cfg)
        specs = sharding.serve_specs(cfg, mesh, max_batch=1, cache_len=64,
                                     model=model).params["layers"]["mamba"]

        def cut(parts):
            return {k: sharding.local_shard(
                v, specs[k][1:], mesh,
                parts=parts.get(f"layers/mamba/{k}", 1)).contiguous()
                for k, v in whole.items()}

        ctx = DistCtx(mesh=mesh, model_axis="model")
        lp, naive = cut(model.param_parts), cut({})
        columns = sharding.column_blocks(
            lp, {k: sharding.PackedSpec(specs[k][1:], sharding.spec_parts(
                specs[k])) for k in lp}, mesh)
    with torch.no_grad(), exact_tp_scope(mesh, columns):
        out, conv, h = T.mamba_path(lp, x, cfg, ctx=ctx)
        res = {"out": out, "conv": conv, "h": h}
        out, conv, h = T.mamba_path(lp, xd, cfg, conv_state=conv.clone(),
                                    h_state=h.clone(), decode=True, ctx=ctx)
        res.update(out_decode=out, conv_decode=conv, h_decode=h)
        if naive is not None:
            res["naive"] = T.mamba_path(naive, x, cfg, ctx=ctx)[0]
    return res


def serve_steps(mesh, payload):
    """build_prefill_step and build_decode_step under make_plan's prefill
    and decode plans over `mesh` (the reference's plan: row-parallel wo,
    a vocab-split table; the decode cache's seq dim over the model axis
    where kv_seq_shard), or one device (mesh None: a mesh of one rank):
    the params cut to this rank's blocks, the last-token logits of a
    prefill of payload["tokens"], then payload["steps"] lockstep decode
    steps of payload["decode"] from a cache whose pos starts at
    payload["start"] (its lines zero), and the cache's k at the end (None
    without one: rwkv6); the
    model group's collectives of the decode steps. An encdec payload
    carries "frames", a vlm one "vis" (the prefill's stub inputs)."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    cfg, params = build(payload["arch"], payload["reduce"],
                        payload.get("replace", {}), payload["seed"])
    model = build_model(cfg)
    tokens = torch.from_numpy(payload["tokens"])
    dec = torch.from_numpy(payload["decode"])
    if mesh is None:
        mesh = make_mesh({"model": 1}, device="cpu", backend="gloo")
    plan = step_lib.make_plan(cfg, mesh, kind="prefill")
    plan_d = step_lib.make_plan(cfg, mesh, kind="decode")
    prefill = step_lib.build_prefill_step(model, plan)
    local = sharding.shard_tree(params, prefill.in_specs[0], mesh)
    batch = {"tokens": tokens}
    for key in ("frames", "vis"):            # whisper's, internvl2's stubs
        if key in payload:
            batch[key] = torch.from_numpy(payload[key]).to(torch.bfloat16)
    logits, _ = prefill(local, batch)
    rows, clen = tokens.shape[0], payload["cache_len"]
    bundle = step_lib.build_decode_step(
        model, plan_d, model.init_cache(rows, clen, abstract=True))
    cache = sharding.shard_tree(model.init_cache(rows, clen, device="cpu"),
                                bundle.in_specs[1], mesh)
    cache["pos"] = torch.tensor(payload["start"], dtype=torch.int32)
    local = sharding.shard_tree(params, bundle.in_specs[0], mesh)
    steps = []
    for i in range(payload["steps"]):
        out, cache = bundle(local, cache, dec[:, i:i + 1])
        steps.append(out.float())
    counts = bundle.model_group.counts
    return {"prefill": logits.float(), "decode": steps, "k": cache.get("k"),
            "kv_seq_shard": plan_d.kv_seq_shard,
            "calls": dict(counts["calls"]), "bytes": dict(counts["bytes"])}


def _shapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        if isinstance(v, dict):
            out.update(_shapes(v, path))
        else:
            out[path] = tuple(v.shape)
    return out


CASES = {"serve": serve, "router": router, "flash_decode": flash_decode,
         "seq_shard_decode": seq_shard_decode, "mesh2d": mesh2d,
         "mamba_op": mamba_op, "serve_steps": serve_steps}
