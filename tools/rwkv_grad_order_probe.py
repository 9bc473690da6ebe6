#!/usr/bin/env python3
"""How far rwkv6-7b's step-0 gradient moves when the same function runs
its products in another order, on the card: the conditioning that a
tensor-parallel step's grad norm is held against (chip_smoke.py phase
19d). rwkv6-7b at full width cut to 8 layers, remat "full", on the
Trainer's step-0 batch (512 x 8, seed 0), as phase 15c trains it.

    python3 tools/rwkv_grad_order_probe.py

Prints the loss, the global grad norm and the largest leaves' norms of
one device's step-0 gradient, computed: as the Trainer does; again (the
same bits); with the WKV's heads in two halves (the heads a rank of 2
holds); with the batch in two halves, the halves' grads averaged (every
product in another order, as on 4 of the 8 rows a data rank would); on
step 1's batch; and over {"model": 2} (two ranks sharing the card over
gloo, the training plan's shards: the TP step's gradient, its split
leaves' norms summed over the ranks). Needs a card; ~70 s.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

LAYERS = 8
SEQ, BATCH = 512, 8


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        path = f"{pre}/{k}" if pre else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _config():
    import repro_torch
    return dataclasses.replace(repro_torch.get_config("rwkv6-7b"),
                               n_layers=LAYERS, remat="full")


def _batch(cfg, step, dev):
    from repro_torch.data.pipeline import DataConfig, TokenSource
    src = TokenSource(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                 vocab_size=cfg.vocab_size, seed=0))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in src.batch_at(step).items()}


def _report(name, loss, norms):
    total = sum(v * v for v in norms.values()) ** 0.5
    top = sorted(((round(v, 3), k) for k, v in norms.items()),
                 reverse=True)[:8]
    print(f"{name}: loss {loss:.5f}, grad norm {total:.4f}; largest leaves "
          f"{top}", flush=True)


def one_device(dev):
    import repro_torch
    from repro_torch.models import rwkv6
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    cfg = _config()
    model = repro_torch.build_model(cfg)
    params = model.init_params(0, device=dev)
    leaves = tree_leaves(params)

    def grads(batch):
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = model.loss_fn(params, batch)
        g = torch.autograd.grad(total, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return (float(metrics["loss"].detach()),
                _flat(tree_unflatten(params, [x.float() for x in g])))

    def norms(g):
        return {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()}

    real = rwkv6.wkv6_chunked

    def heads_in_halves(r, k, v, w, u, state, *, chunk=64):
        h = r.shape[2] // 2
        outs = [real(*(a[:, :, i * h:(i + 1) * h] for a in (r, k, v, w)),
                     u[i * h:(i + 1) * h], state[:, i * h:(i + 1) * h],
                     chunk=chunk) for i in (0, 1)]
        return (torch.cat([o[0] for o in outs], 2),
                torch.cat([o[1] for o in outs], 1))

    b0 = _batch(cfg, 0, dev)
    for name in ("as the Trainer", "again"):
        loss, g = grads(b0)
        _report(name, loss, norms(g))
    rwkv6.wkv6_chunked = heads_in_halves
    try:
        loss, g = grads(b0)
    finally:
        rwkv6.wkv6_chunked = real
    _report("the WKV's heads in two halves", loss, norms(g))
    (l1, g1), (l2, g2) = (grads({k: v[i:i + BATCH // 2]
                                 for k, v in b0.items()})
                          for i in (0, BATCH // 2))
    _report("the batch in two halves", (l1 + l2) / 2,
            norms({k: (g1[k] + g2[k]) / 2 for k in g1}))
    loss, g = grads(_batch(cfg, 1, dev))
    _report("step 1's batch", loss, norms(g))


def tp_rank(rank, n, store, out):
    import torch.distributed as dist
    import repro_torch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.train import step as step_lib
    torch.cuda.set_device(0)
    mesh = make_mesh({"model": n}, device="cuda:0", backend="gloo",
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=600)
    cfg = _config()
    model = repro_torch.build_model(cfg)
    plan = step_lib.make_plan(cfg, mesh, kind="train")
    bundle, _ = step_lib.build_train_step(model, plan)
    specs = bundle.in_specs[0]
    params = sharding.shard_tree(model.init_params(0, device=mesh.device),
                                 specs, mesh)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = step_lib.make_dist_ctx(plan)
    total, metrics = model.loss_fn(params, _batch(cfg, 0, mesh.device), ctx)
    g = _flat(tree_unflatten(params, list(torch.autograd.grad(total,
                                                              leaves))))
    mdims = _flat(sharding.model_dims(plan, specs))
    norms = {}
    for k, v in g.items():
        sq = torch.sum(v.float() ** 2)
        if mdims[k] is not None:
            sq = bundle.model_group.all_reduce(sq)
        norms[k] = float(sq) ** 0.5
    if rank == 0:
        torch.save({"loss": float(metrics["loss"].detach()),
                    "norms": norms}, out)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(torch.cuda.get_device_name(0), flush=True)
    one_device(torch.device("cuda"))
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="rwkv_probe_")
    out = os.path.join(work, "tp.pt")
    mp.start_processes(tp_rank, args=(2, os.path.join(work, "store"), out),
                       nprocs=2, start_method="spawn")
    r = torch.load(out)
    _report('over {"model": 2} (gloo, one card)', r["loss"], r["norms"])


if __name__ == "__main__":
    main()
