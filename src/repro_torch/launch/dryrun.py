"""Multi-pod dry-run launcher — the port of `repro.launch.dryrun`.

For every (architecture x input shape) cell this builds the cell's step
(train, prefill or decode; train/step.py) under the reference's default
plan over the production mesh — (16, 16) = 256 ranks in one pod,
(2, 16, 16) = 512 ranks over two — as ONE RANK of an abstract mesh
(`launch.mesh.abstract_mesh`: no process, no process group), and counts
that rank's call on fake tensors (`analyze.census.census_step`):

  * the live bytes' high-water mark, arguments included (whether the
    cell fits the card's memory, `GpuSpec.memory_bytes`);
  * FLOPs, tensor-core FLOPs, bytes every op moves and launches;
  * the collectives by group and kind (the step's `AxesGroup.counts`);
  * the three roofline terms and the dominant one (`core.roofline.
    analyze_step`).

It needs no card, starts no process, allocates no tensor memory and
launches nothing: the fake tensors sit on the CPU, so it counts the plain
versions in the kernels' places. `--flash` and `--ssm-kernel` then swap
in the kernels' byte models (`flash_adjustment`, `ssm_kernel_adjustment`)
as the reference does. Its seconds are MODELED from `h100-sxm5`'s
data-sheet peaks (`core.hw.DEFAULT_SPEC`), never measured.

The reference's `hbm_adjusted` correction (CPU XLA implements no
donation, so the donated buffers were counted twice or three times in
temp) has no counterpart: the census counts every storage once, a
donated argument updated in place included, so `hbm_adjusted_gib` is
the high-water mark itself.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all                 # 16x16 table
  python -m repro_torch.launch.dryrun --all --multi-pod     # 2x16x16
  python -m repro_torch.launch.dryrun --all --both
Rows land in runs/dryrun_torch/*.json. A cell that fails prints
`FAIL [...]` with the exception's words, and the run exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import (ARCH_IDS, SHAPES, applicable_shapes,
                                      get_config)
from repro_torch.core import hw, roofline
from repro_torch.kernels.flash.flash_cuda import BLK_Q_INSTANCES
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import (DATA_AXES, abstract_mesh,
                                     production_shape)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "runs", "dryrun_torch")
# the largest q block the port's forward flash kernel is compiled with;
# the reference's is 256
FLASH_BLK_Q = max(BLK_Q_INSTANCES)


def _dp(mesh) -> int:
    return math.prod(mesh.shape[a] for a in DATA_AXES if a in mesh.shape)


def model_flops_for_cell(cfg, shape_name: str) -> float:
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch          # one decode step


def auto_microbatches(cfg, shape, mesh) -> int:
    """Pick grad-accumulation depth so the saved per-layer hidden states
    stay ~<=2.5 GiB a rank (the dominant train-time residency)."""
    b_local = max(1, shape.global_batch // _dp(mesh))
    saved = cfg.n_layers * b_local * shape.seq_len * cfg.d_model * 2
    target = 2.5 * 2 ** 30
    mb = 1
    while saved / mb > target and mb < b_local:
        mb *= 2
    return mb


def build_cell(arch: str, shape_name: str, mesh, *, fsdp=None,
               kv_seq_shard=None, remat=None, grad_compress="none",
               microbatches=None, ssm_impl=None):
    """(bundle, the cell's abstract inputs, microbatches) of one cell over
    `mesh`: the config (remat and ssm_impl overridable), the reference's
    default plan (train/step.make_plan; fsdp and kv_seq_shard
    overridable) and the step. As in the reference, the flash kernel is
    never switched on for the count: `flash_adjustment` prices it."""
    from repro_torch.models.registry import build_model
    from repro_torch.train import step as step_lib
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if ssm_impl is not None:
        cfg = dataclasses.replace(cfg, ssm_impl=ssm_impl)
    model = build_model(cfg)
    cell = specs_lib.input_specs(cfg, shape_name)
    kind = cell["kind"]
    plan = step_lib.make_plan(cfg, mesh, kind=kind, fsdp=fsdp,
                              kv_seq_shard=kv_seq_shard)
    mb = 1
    if kind == "train":
        mb = microbatches or auto_microbatches(cfg, SHAPES[shape_name],
                                               mesh)
        bundle, _ = step_lib.build_train_step(
            model, plan, grad_compress=grad_compress, microbatches=mb)
    elif kind == "prefill":
        bundle = step_lib.build_prefill_step(model, plan)
    else:
        bundle = step_lib.build_decode_step(model, plan, cell["cache"])
    return bundle, cell, mb


def census_cell(arch: str, shape_name: str, mesh, *, fsdp=None,
                kv_seq_shard=None, remat=None, grad_compress="none",
                microbatches=None, ssm_impl=None, rank: int = 0):
    """The counterpart of the reference's `lower_cell`: one cell built
    over `mesh` (a mapping name -> size, or a Mesh) as rank `rank` of an
    abstract mesh and counted (analyze.census.census_step). Returns
    (census, plan, microbatches)."""
    from repro_torch.analyze.census import census_step
    if isinstance(mesh, dict):
        mesh = abstract_mesh(mesh, rank=rank)
    bundle, cell, mb = build_cell(
        arch, shape_name, mesh, fsdp=fsdp, kv_seq_shard=kv_seq_shard,
        remat=remat, grad_compress=grad_compress, microbatches=microbatches,
        ssm_impl=ssm_impl)
    return census_step(bundle, cell["batch"], microbatches=mb), \
        bundle.plan, mb


def donated_bytes(arch: str, shape_name: str, mesh, **kw) -> int:
    """The counterpart of the reference's `_donated_bytes`: a rank's bytes
    of what the step updates in place (params and optimizer state in
    training, the cache in decode, 0 in prefill) under the cell's plan,
    from the abstract trees cut to the rank's blocks (no step is run)."""
    from repro_torch.analyze.census import argument_bytes, step_arguments
    if isinstance(mesh, dict):
        mesh = abstract_mesh(mesh)
    bundle, cell, mb = build_cell(arch, shape_name, mesh, **kw)
    return argument_bytes(bundle, step_arguments(bundle, cell["batch"]),
                          mb)[1]


def flash_adjustment(cfg, shape_name: str, mesh, plan=None,
                     blk_q: int = FLASH_BLK_Q) -> dict:
    """Analytic traffic delta for replacing the plain attention's score
    chain with the flash kernel (kernels/flash; the reference's formula).

    Plain path a layer-pass a rank: the (B,KvH,G,Sq,Skv) f32 score tensor
    is materialized ~3x (scores+mask, softmax, probs) = c*B*H*Sq*Skv*4 B.
    Flash path: q/out streamed once; k/v re-fetched once a q block
    (n_q = Sq/blk_q revisits). Passes: train = fwd + remat-fwd + bwd(dq)
    + bwd(dkv) = 4; prefill = 1. blk_q is the q block (the port's kernel:
    FLASH_BLK_Q; the reference's 256)."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" or cfg.family in ("ssm",):
        return {"score_bytes": 0.0, "flash_bytes": 0.0}
    tp = mesh.shape["model"]
    b_loc = max(1, shape.global_batch // _dp(mesh))
    h_loc = cfg.n_heads // tp if cfg.n_heads % tp == 0 and \
        cfg.n_kv_heads % tp == 0 else cfg.n_heads
    kv_loc = max(1, h_loc * cfg.n_kv_heads // cfg.n_heads)
    sq = skv = shape.seq_len
    layers = cfg.n_layers
    passes = 4.0 if shape.kind == "train" else 1.0
    causal_frac = 0.5 if shape.kind in ("train", "prefill") else 1.0
    c_mat = 3.0                                   # score-chain materializations
    score = passes * layers * c_mat * b_loc * h_loc * sq * skv * 4 * causal_frac
    n_q = sq // blk_q
    qo = 2 * b_loc * h_loc * sq * cfg.head_dim * 2          # q + out
    kv = 2 * b_loc * kv_loc * skv * cfg.head_dim * 2 * n_q * causal_frac
    flash = passes * layers * (qo + kv)
    return {"score_bytes": float(score), "flash_bytes": float(flash)}


def ssm_kernel_adjustment(cfg, shape_name: str, mesh) -> float:
    """Analytic HBM traffic of the selective-scan kernel
    (kernels/ssm/ssm_cuda.kernel_hbm_bytes) a rank a step — added back
    when the cell is counted with ssm_impl="stub" (the kernel replaces the
    stubbed scan one for one)."""
    from repro_torch.kernels.ssm.ssm_cuda import kernel_hbm_bytes
    shape = SHAPES[shape_name]
    b_loc = max(1, shape.global_batch // _dp(mesh))
    ci = 2 * cfg.d_model
    passes = 4.0 if shape.kind == "train" else 1.0
    per_layer = kernel_hbm_bytes(b_loc, shape.seq_len, ci, cfg.ssm_state)
    return passes * cfg.n_layers * per_layer


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             save: bool = True, verbose: bool = True, flash: bool = False,
             ssm_kernel: bool = False, **kw) -> Dict:
    """One cell on the production mesh's shape: rank 0's census priced on
    hw.DEFAULT_SPEC (modeled seconds), the kernels' byte models swapped in
    with flash/ssm_kernel, the row saved to OUT_DIR."""
    spec = hw.DEFAULT_SPEC
    mesh = abstract_mesh(production_shape(multi_pod))
    mesh_shape = tuple(mesh.shape[a] for a in mesh.axis_names)
    cfg = get_config(arch)
    if ssm_kernel:
        kw = dict(kw, ssm_impl="stub")
    t0 = time.time()
    census, plan, mb = census_cell(arch, shape_name, mesh, **kw)
    census_s = time.time() - t0

    rep = roofline.analyze_step(
        f"{arch}/{shape_name}", census, spec=spec,
        model_flops_total=model_flops_for_cell(cfg, shape_name))
    if flash:
        adj = flash_adjustment(cfg, shape_name, mesh, plan)
        new_bytes = max(0.0, rep.bytes_per_chip - adj["score_bytes"]
                        + adj["flash_bytes"])
        rep.bytes_per_chip = new_bytes
        rep.memory_s = new_bytes / spec.hbm_bw
        rep.extra["flash_adjustment"] = adj
    if ssm_kernel:
        kb = ssm_kernel_adjustment(cfg, shape_name, mesh)
        rep.bytes_per_chip += kb
        rep.memory_s = rep.bytes_per_chip / spec.hbm_bw
        rep.extra["ssm_kernel_bytes"] = kb
    row = rep.row()
    peak = census.peak_live_bytes
    row.update(
        multi_pod=multi_pod,
        compile_s=census_s,          # the census's seconds on this host
        collective_by_kind=rep.extra["collective_bytes_by_kind"],
        collective_counts=rep.extra["collective_count_by_kind"],
        collectives_by_group=census.collectives,
        fsdp=plan.fsdp, kv_seq_shard=plan.kv_seq_shard, flash=flash,
        ssm_kernel=ssm_kernel,
        microbatches=mb,
        flops=census.flops, tc_flops=census.tc_flops,
        op_bytes=census.op_bytes, launches=census.launches,
        tree_gib={k: v / 2 ** 30 for k, v in census.tree_bytes.items()},
        donated_gib=census.state_bytes / 2 ** 30,
        hbm_adjusted_gib=peak / 2 ** 30,
        fits_hbm=bool(peak < spec.memory_bytes),
        spec=spec.name, modeled=True,
    )
    if verbose:
        print(f"[{arch} x {shape_name} mesh={mesh_shape} rank {mesh.rank}] "
              f"census={census_s:.1f}s live peak/rank="
              f"{peak / 2 ** 30:.2f}GiB (fits {spec.memory_bytes / 2 ** 30:.2f}"
              f": {row['fits_hbm']}) modeled on {spec.name}'s data-sheet "
              f"peaks: compute={rep.compute_s:.4g}s memory="
              f"{rep.memory_s:.4g}s collective={rep.collective_s:.4g}s "
              f"dominant={rep.dominant} useful="
              f"{rep.useful_flops_ratio and f'{rep.useful_flops_ratio:.2f}'}",
              flush=True)
        print(f"  trees GiB/rank: "
              f"{ {k: round(v, 3) for k, v in row['tree_gib'].items()} } "
              f"launches={census.launches} microbatches={mb}")
        print(f"  collectives: {census.collectives}")
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        tag = "multi" if multi_pod else "single"
        path = os.path.join(OUT_DIR, f"{arch}__{shape_name}__{tag}.json")
        with open(path, "w") as fh:
            json.dump(row, fh, indent=1, default=float)
    return row


def main(argv: Optional[Tuple[str, ...]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run each cell on both meshes")
    ap.add_argument("--fsdp", type=int, default=None)
    ap.add_argument("--kv-seq-shard", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--grad-compress", default="none")
    ap.add_argument("--flash", action="store_true",
                    help="price attention as the flash kernel")
    ap.add_argument("--ssm-kernel", action="store_true",
                    help="price the mamba scan as the selective-scan kernel")
    args = ap.parse_args(argv)

    kw = dict(fsdp=None if args.fsdp is None else bool(args.fsdp),
              kv_seq_shard=(None if args.kv_seq_shard is None
                            else bool(args.kv_seq_shard)),
              remat=args.remat, grad_compress=args.grad_compress)
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for sh in applicable_shapes(get_config(arch)):
                cells.append((arch, sh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    pods = [args.multi_pod] if not args.both else [False, True]
    failures, rows = [], []
    for arch, sh in cells:
        for mp in pods:
            try:
                rows.append(run_cell(arch, sh, multi_pod=mp, flash=args.flash,
                                     ssm_kernel=args.ssm_kernel, **kw))
            except Exception as e:
                failures.append((arch, sh, mp, repr(e)))
                print(f"FAIL [{arch} x {sh} multi_pod={mp}]: {e}",
                      flush=True)
                traceback.print_exc()
    if rows:
        spec = hw.DEFAULT_SPEC
        print(f"\nmodeled on {spec.name} ({spec.part}), data-sheet peaks, "
              f"not measured; one rank's census:")
        print(format_rows(rows))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(cells) * len(pods)} cells counted OK")


def format_rows(rows) -> str:
    """Markdown table of dry-run rows (modeled seconds)."""
    cols = [("cell", "name", "{}"), ("mesh", "mesh", "{}"),
            ("compute_s", "compute_s", "{:.4g}"),
            ("memory_s", "memory_s", "{:.4g}"),
            ("collective_s", "collective_s", "{:.4g}"),
            ("dominant", "dominant", "{}"), ("step_s", "step_s", "{:.4g}"),
            ("tc%", "tc_frac", "{:.1%}"), ("useful", "useful_ratio", "{:.2f}"),
            ("GiB/rank", "hbm_gib_per_chip", "{:.2f}"),
            ("fits", "fits_hbm", "{}"),
            ("coll GiB", "collective_gib", "{:.3f}")]
    lines = ["| " + " | ".join(c[0] for c in cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        r = dict(r, collective_gib=sum(r["collective_by_kind"].values())
                 / 2 ** 30)
        lines.append("| " + " | ".join(
            "—" if r.get(k) is None else fmt.format(r[k])
            for _, k, fmt in cols) + " |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
