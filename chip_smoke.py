#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
H100: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (one line each, more where noted):
  1. require a CUDA card of capability (9, 0); print its name and power
     limit as nvidia-smi reports them;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print each
     compiled instance's registers and spills;
  3. hold each kernel against its plain version on the card at BENCH and
     Si-214 (gpp_fused at V9, gpp_banded at V6, V7 and V8): partials and
     totals within max-norm relative TOL_PLAIN[size]; at BENCH also the totals
     against the complex128 oracle ref_numpy within TOL_REF;
  4. the main path: repro_torch.dispatch("gpp", make_inputs(SI214)) — v10,
     tuned on the card (the candidates ranked and each timed config's ms
     are printed);
  5. the journey: v0–v5 and v6–v10 at Si-214 through the registry;
  6. the main path's result held against the plain version (f32) within
     TOL_PLAIN and against a float64 run of it (on the same float32 inputs)
     within TOL_F64; times (CUDA
     events, median after warm-up); the kernels line.
Each path (phase 4's dispatch, phase 5's journey) runs with the launch
counters zeroed just before it and read just after; the kernels line
gives each path's counts and their sum, and fails unless every kernel
launched on the paths that run it (gpp_fused on both, gpp_banded on the
journey).

The last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without it. Without a card, or outside the repository, the
script fails before printing any result.
"""

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Kernel vs plain version, both float32, max-norm relative over partials
# and over totals. The two sum in another order (per-thread runs over the
# band chunks, then a block tree, in the kernel; one plane sum per band,
# then a run over the bands, in the plain version). At BENCH that costs a
# few 1e-6. At Si-214 terms near the poles of 1/|wdiff|^2 and 1/|cden|^2
# make the float32 sums ill-conditioned: phase 6 prints how far each of
# the two lies from a float64 run on the same (float32-rounded) inputs,
# and the two float32 results differ by about 1e-3 of the largest partial.
TOL_PLAIN = {"bench": 1e-4, "si214": 5e-3}
# planar f32 against complex128 at BENCH (tests/test_gpp_kernel.py:162)
TOL_REF = 1e-4
# the main path's totals against a float64 run of the plain version on the
# same float32 inputs at Si-214 (the arithmetic's error alone)
TOL_F64 = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel(a, b) -> float:
    """Max-norm relative error of a against b (torch or numpy)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"{torch.cuda.get_device_name(0)} has capability {cap}, "
             "the kernels are built for sm_90a")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; capability {cap}", flush=True)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    import repro_torch
    from repro_torch.core import hw
    from repro_torch.core.journey import format_row, run_journey
    from repro_torch.kernels import _build, api
    from repro_torch.kernels.gpp import gpp_cuda, problem, ref
    from repro_torch.tune import measure, tuner

    # a fresh tune cache, so the main path tunes on this card
    tune_dir = os.path.join(ROOT, "build", "chip_smoke_tune")
    shutil.rmtree(tune_dir, ignore_errors=True)
    os.environ["REPRO_TUNE_CACHE"] = tune_dir
    dev = torch.device("cuda")
    spec = hw.spec_for_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    attrs = {c.name: gpp_cuda.kernel_attrs(c) for c in gpp_cuda.CONFIGS.values()}
    model = {c.name: c.regs_estimate() for c in gpp_cuda.CONFIGS.values()}
    print(f"[2] built {sorted(libs)} in {build_s:.1f} s; compiled (regs, spill "
          f"bytes) per config: {attrs}; register table: {model}", flush=True)

    # -- 3. each kernel against its plain version ----------------------------
    checks = (("gpp_fused", gpp_cuda.gpp_fused, gpp_cuda.gpp_fused_plain,
               gpp_cuda.V9),
              ("gpp_banded", gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain,
               gpp_cuda.V6),
              ("gpp_banded", gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain,
               gpp_cuda.V7),
              ("gpp_banded", gpp_cuda.gpp_banded, gpp_cuda.gpp_banded_plain,
               gpp_cuda.V8))
    compared = {}
    for size in (problem.BENCH, problem.SI214):
        inp = problem.make_inputs(size)
        t = problem.to_tensors(inp, dev)
        oracle = ref.ref_numpy(inp) if size is problem.BENCH else None
        for name, kern, plain, base in checks:
            cfg = base.clamped(size)
            got = kern(t, cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = plain(t, cfg)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"{name} {cfg.name} {size.name}: shape {tuple(got.shape)} "
                     f"vs {tuple(want.shape)} or non-finite partials")
            err_p = rel(got.cpu(), want.cpu())
            tot_got = got.reshape(-1, 4, size.nw).sum(0).cpu()
            tot_want = want.reshape(-1, 4, size.nw).sum(0).cpu()
            err_t = rel(tot_got, tot_want)
            line = (f"[3] {name} {cfg.name} {size.name}: partials "
                    f"{tuple(got.shape)} max_abs_err "
                    f"{float((got - want).abs().max()):.3e} rel {err_p:.2e}, "
                    f"totals rel {err_t:.2e} (tol {TOL_PLAIN[size.name]})")
            if max(err_p, err_t) > TOL_PLAIN[size.name]:
                fail(line)
            if oracle is not None:
                tot = tot_got.to(torch.float64).numpy()
                err_r = max(rel(tot[0] + 1j * tot[1], oracle[0]),
                            rel(tot[2] + 1j * tot[3], oracle[1]))
                line += f"; vs ref_numpy {err_r:.2e} (tol {TOL_REF})"
                if err_r > TOL_REF:
                    fail(line)
            ms = measure.time_callable(lambda: kern(t, cfg), device=dev,
                                       warmup=1, reps=5) * 1e3
            line += f"; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms [{card}]"
            print(line, flush=True)
            compared[(name, cfg.name, size.name)] = {
                "max_abs_err": float((got - want).abs().max()), "ms": ms,
                "plain_ms": plain_ms}
        del t

    # -- 4. the main path: dispatch at Si-214 (v10, tuned on the card) --------
    size = problem.SI214
    inp = problem.make_inputs(size)
    counters = (gpp_cuda.gpp_fused, gpp_cuda.gpp_banded)

    def zero_counts():
        for f in counters:
            f.launches = 0

    def read_counts():
        return {f.__name__: f.launches for f in counters}

    zero_counts()
    ach, asx = repro_torch.dispatch("gpp", inp)
    torch.cuda.synchronize()
    by_path = {"dispatch": read_counts()}
    if by_path["dispatch"]["gpp_fused"] == 0:
        fail("dispatch('gpp') did not launch gpp_fused")
    if ach.shape != (size.nw,) or not (torch.isfinite(ach).all()
                                       and torch.isfinite(asx).all()):
        fail(f"main path output: shape {tuple(ach.shape)}, finite "
             f"{bool(torch.isfinite(ach).all())}/{bool(torch.isfinite(asx).all())}")
    tc = tuner.tune_kernel("gpp", size, device=dev)     # the memoized pick
    timed = ", ".join(f"({c.blk_ig},{c.blk_igp},{c.blk_band},t{c.threads}) "
                      f"{s * 1e3:.3f} ms" for c, s, _ in tc.timings)
    print(f"[4] dispatch('gpp') si214: launches {by_path['dispatch']}, "
          f"ach/asx finite, shape {tuple(ach.shape)}; the tuner ranked "
          f"{tc.ranked} candidates and timed {len(tc.timings)}: {timed}; "
          f"picked ({tc.config.blk_ig},{tc.config.blk_igp},"
          f"{tc.config.blk_band},t{tc.config.threads}) [{card}]", flush=True)

    # -- 5. the journey --------------------------------------------------------
    zero_counts()
    rows = run_journey("si214", device=dev, warmup=1, reps=1,
                       versions=("v0", "v1", "v2", "v3", "v4", "v5"),
                       verbose=False)
    rows += run_journey("si214", device=dev, warmup=1, reps=5,
                        versions=("v6", "v7", "v8", "v9", "v10"),
                        verbose=False)
    torch.cuda.synchronize()
    by_path["journey"] = read_counts()
    for r in rows:
        print(f"[5] {format_row(r)} [{card}]", flush=True)
    print(f"[5] journey launches {by_path['journey']}", flush=True)
    for path, names in (("dispatch", ("gpp_fused",)),
                        ("journey", ("gpp_fused", "gpp_banded"))):
        for name in names:
            if by_path[path][name] <= 0:
                fail(f"{name} was not launched on the {path} path")
    bad = [r.version for r in rows if not r.rel_err < 1e-4]
    if bad:
        fail(f"journey versions off the oracle at TINY: {bad}")

    # -- 6. the main path's result against the plain version, times ----------
    t = problem.to_tensors(inp, dev)
    tuned = api.resolve_config("gpp", t)
    t1 = time.perf_counter()
    want = gpp_cuda.gpp_fused_plain(t, tuned)
    torch.cuda.synchronize()
    fused_plain_ms = (time.perf_counter() - t1) * 1e3
    got = gpp_cuda.gpp_fused(t, tuned)     # the partials behind dispatch's sums
    fused_err = float((got - want).abs().max())
    err_parts = rel(got.cpu(), want.cpu())
    sums = want.sum((0, 1)).cpu()
    err_plain = max(rel(ach.cpu(), torch.complex(sums[0], sums[1])),
                    rel(asx.cpu(), torch.complex(sums[2], sums[3])))
    p64 = gpp_cuda.gpp_fused_plain({k: v.double() for k, v in t.items()}, tuned)
    s64 = p64.sum((0, 1)).cpu().numpy()
    err_f64 = max(rel(ach.cpu().numpy().astype(np.complex128), s64[0] + 1j * s64[1]),
                  rel(asx.cpu().numpy().astype(np.complex128), s64[2] + 1j * s64[3]))
    plain_f64 = max(rel(torch.complex(sums[0], sums[1]).numpy().astype(np.complex128),
                        s64[0] + 1j * s64[1]),
                    rel(torch.complex(sums[2], sums[3]).numpy().astype(np.complex128),
                        s64[2] + 1j * s64[3]))
    line = (f"[6] main path v10 cfg {tuned}: partials vs plain f32 rel "
            f"{err_parts:.2e}, totals vs plain f32 {err_plain:.2e} (tol "
            f"{TOL_PLAIN[size.name]}); against float64 on the same inputs: "
            f"kernel partials {rel(got.cpu().double(), p64.cpu()):.2e} totals "
            f"{err_f64:.2e} (tol {TOL_F64}), plain f32 partials "
            f"{rel(want.cpu().double(), p64.cpu()):.2e} totals {plain_f64:.2e}; "
            f"plain f32 {fused_plain_ms:.1f} ms")
    print(line, flush=True)
    if max(err_parts, err_plain) > TOL_PLAIN[size.name] or err_f64 > TOL_F64:
        fail(line)
    disp_ms = measure.time_callable(lambda: repro_torch.dispatch("gpp", t),
                                    device=dev, warmup=1, reps=5) * 1e3
    fused_ms = measure.time_callable(lambda: gpp_cuda.gpp_fused(t, tuned),
                                     device=dev, warmup=1, reps=5) * 1e3
    ops_ms = size.total_flops() / spec.fp32_flops * 1e3
    bytes_ms = size.min_hbm_bytes() / spec.hbm_bw * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[6] dispatch('gpp') si214: {disp_ms:.3f} ms "
          f"{size.total_flops() / disp_ms / 1e9:.3f} TFLOP/s "
          f"({size.total_flops() / disp_ms / 1e9 / spec.fp32_flops * 1e12:.1%} "
          f"of the {spec.part} FP32 peak); gpp_fused alone {fused_ms:.3f} ms; "
          f"bound {bound_ms:.3f} ms ({bound_by}: {ops_ms:.3f} ms of FP32 at "
          f"{spec.fp32_flops / 1e12:.0f} TFLOP/s, {bytes_ms:.4f} ms of bytes) "
          f"[{card}]", flush=True)
    banded = compared[("gpp_banded", "v8", "si214")]
    launches = {name: {path: n[name] for path, n in by_path.items()}
                for name in ("gpp_fused", "gpp_banded")}
    kernels = [
        {"name": "gpp_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/gpp.cu",
         "replaces": "src/repro/kernels/gpp/pallas_gpp.py:219",
         "launches": sum(launches["gpp_fused"].values()),
         "launches_by_path": launches["gpp_fused"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "gpp_banded", "route": "cuda",
         "source": "src/repro_torch/csrc/gpp.cu",
         "replaces": "src/repro/kernels/gpp/pallas_gpp.py:192",
         "launches": sum(launches["gpp_banded"].values()),
         "launches_by_path": launches["gpp_banded"],
         "max_abs_err": banded["max_abs_err"], "ms": banded["ms"],
         "plain_ms": banded["plain_ms"], "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
