#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
H100: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (one line each, more where noted):
  1. require a CUDA card of capability (9, 0); print its name and power
     limit as nvidia-smi reports them;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print each
     compiled instance's registers and spills, and how many clusters of
     flash_bwd_dkv CTAs the card holds at once; hold the shared helpers of
     csrc/sm90.cuh alone: one wgmma product per operand mode, N and K
     against torch.matmul (SM90_RTOL) and TMA boxes against slices;
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
     within TOL_F64; times (CUDA events, median after warm-up);
  7. flash_fwd at op level: the kernel against flash_fwd_plain on the card
     (out within FLASH_OUT_ULPS bf16 ulps, lse within FLASH_LSE_ATOL) at
     qwen2-1.5b's attention shape (B=1, H=12, KvH=2, Hd=128) for S = 256,
     512 and 4096 and at the training shape (B=8, S=512), at codeqwen's MHA
     shape (H = KvH = 32, S = 512) and at one config with blk_q != blk_kv;
     at S = 512 also against the f32 oracle ref.reference; each with the
     kernel's, the plain version's and scaled_dot_product_attention's ms
     (timed here only) and the bound, and the kernel's and SDPA's device
     ms replayed from a CUDA graph; at S = 512 and 4096 and the training
     shape the model's block pick beside a timed sweep of the whole menu;
  7b. flash_bwd_dq and flash_bwd_dkv at op level: each kernel against its
     plain version on the kernel forward's lse (within one bf16 ulp at the
     largest element, BWD_ULPS) at the training shape (B=8, S=512, H=12,
     KvH=2, Hd=128) and at B=1, S=4096, at codeqwen's MHA shape (group 1),
     phi4-mini's heads (H=24, KvH=8: group 3), a group of 16 (dkv's f32
     partials), other blocks for each kernel and non-causal; at the
     training shape and S=4096 flash_bwd_dkv bit-equal over two launches;
     at the training shape also the FlashAttention gradient against
     autograd through the f32 oracle (BWD_REF_RTOL); the kernels', the
     plain versions' and the backward of scaled_dot_product_attention's ms
     (timed here only) and the bounds;
  8. dense serving, the slice's path: ServeEngine on qwen2-1.5b at full
     width and depth with use_flash_attention=True, weights from seed 0,
     max_batch=4, cache_len=1024: 8 greedy requests (prompts of 160, 256,
     300 and 480 tokens, two each) and one at temperature 0.8, 32 new
     tokens each. flash_fwd must launch 28 times a prefill; TTFT, decode
     ms a step, tokens/s and peak device memory are printed; one admission
     round and three decode rounds run under torch.profiler (device-busy
     share, top kernels, top host ops). Each request's prompt is then
     prefilled again: every flash_fwd launch is held against
     flash_fwd_plain on the same inputs (FLASH_OUT_ULPS), and the
     first-token logits against the same model with flash_fwd_plain in
     the kernel's place and against the engine with flash off (the
     chunked plain path), both within SERVE_LOGIT_RTOL; the kernels line.
  7c. ssm_scan at op level: the kernel against ssm_scan_plain on the card
     (y within SSM_RTOL of the largest |y|, hT within SSM_RTOL of the
     largest |hT|) at hymba-1.5b's prefill (B=1, T=1152, C=3200, N=16),
     T=4096, B=4 x T=256, a small N=8 shape with a ragged time tile, and
     the prefill shape with a nonzero h0; the kernel's and the plain
     version's ms and the bound (no PyTorch call computes the scan); at
     the prefill shape every blk_c of the config space, modeled and timed;
  10. training, the third slice's path: Trainer(...).run() on qwen2-1.5b
     at full width and depth (remat "full", AdamW, flash on), the
     TrainLoopConfig defaults (seq_len 512, global_batch 8), 4 steps,
     one checkpoint at the end under build/. The step-0 loss within
     LOSS0_ATOL of what random weights give (see LOSS0_ATOL), every loss
     finite; every step
     launches flash_fwd 56 times (forward and remat recompute) and each
     backward kernel 28 times; step ms, tokens/s, mfu, peak memory; the
     save's size and time; resume_or_init restores every leaf bit-equal
     to the state in memory. Then one step under torch.profiler and one
     more with every backward launch held against its plain version on
     its own inputs (BWD_ULPS).
  11. hybrid serving, the fourth slice's path: ServeEngine on hymba-1.5b
     at full width and depth with ssm_impl="pallas", weights from seed 0,
     max_batch=4, cache_len=2048: 8 greedy requests (SERVE_PROMPTS) and
     one of 1152 tokens (longer than the 1024 window: the prefill's ring
     roll and ring decode), 32 new tokens each, all submitted at once.
     ssm_scan must launch 32 times a prefill; TTFT, decode ms a round,
     tokens/s and peak device memory are printed; one admission round and
     three decode rounds run under torch.profiler. Then the long prompt
     is prefilled again with every ssm_scan launch held against
     ssm_scan_plain on its inputs (SSM_RTOL), and every prompt's
     first-token logits against the engine with ssm_impl="chunked"
     (SERVE_LOGIT_RTOL).
Each path (phase 4's dispatch, phase 5's journey, phase 7's flash checks,
phase 8's serving run, phase 10's training run, phase 11's hybrid serving
run) runs with the launch counters zeroed just before it and read just
after; the kernels line gives each path's counts, and the script fails
unless every kernel launched on the paths that run it (gpp_fused on
dispatch and journey, gpp_banded on the journey, flash_fwd 28 times a
prefill on the serving run, flash_fwd 56 and each backward kernel 28
times a training step, ssm_scan 32 times a prefill on the hybrid serving
run).

The last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without it. Without a card, or outside the repository, the
script fails before printing any result.
"""

import contextlib
import gc
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
# flash_fwd against flash_fwd_plain, compared in the working type (bf16
# out): within 2 bf16 ulps of each value's magnitude (an ulp is at most
# 2^-7 of it; floor 1% of the largest), since the kernel multiplies P V
# with a bf16 hi+lo split of p (~16 bits) and the tensor cores sum in
# another order than the plain f32 einsums, and each side rounds once to
# bf16. lse (f32, magnitude ~10) within 1e-4.
FLASH_OUT_ULPS = 2
FLASH_LSE_ATOL = 1e-4
# first-token logits in the served model, as max |difference| over max
# |logit|. bf16 evaluation of this random-weight 28-layer model has a
# floor: a one-ulp change in a few attention outputs of one layer moves
# the logits by about as much as any larger change, and the first
# full-width runs measured 2.5e-2 to 3.4e-2 between the kernel path and
# the same model with flash_fwd_plain in the kernel's place (every launch
# within 1 ulp of the plain version on its own inputs), and 3.3e-2 to
# 3.8e-2 against the chunked path (PERF.md). So both are held to 6e-2;
# the kernel itself is held at every launch of those prefills to
# FLASH_OUT_ULPS against its plain version on the same inputs.
SERVE_LOGIT_RTOL = 6e-2
SERVE_PROMPTS = (160, 160, 256, 256, 300, 300, 480, 480)
# sm90.cuh's wgmma alone against torch.matmul in f32 on the same bf16
# values: the products are exact in f32 and the sums (K <= 128 terms) run
# in another order, a few f32 ulps of the largest product
SM90_RTOL = 1e-5
# flash_bwd_dq / flash_bwd_dkv against their plain versions, both bf16
# out: max |difference| within one bf16 ulp at the largest |plain| element
# (2^(floor(log2 max) - 7)): both sum in f32 and round once, the kernel
# multiplies ds and p as a bf16 hi + lo split and sums in another order
BWD_ULPS = 1
# the FlashAttention gradient (bf16 in and out) against autograd through
# the f32 oracle on the same values, max-norm relative: the kernel path
# rounds out to bf16 before delta = rowsum(dout * out) and the grads to
# bf16 (2^-9 and 2^-8 of the largest), the oracle neither
BWD_REF_RTOL = 2.0 ** -6
# training from random weights: the final norm leaves each hidden row at
# RMS 1 and the tied table's entries are N(0, 0.02^2), so the step-0
# logits are ~N(0, s2), s2 = 0.02^2 d_model, independent of the label:
# E[lse] = ln V + s2 / 2, and the loss is lse + 1e-4 lse^2 (the z-loss).
# At qwen2-1.5b's d_model 1536 that is 12.2536; ln V + 1e-4 (ln V)^2 alone
# (11.945) leaves out the logits' spread.
LOSS0_ATOL = 0.05
INIT_SCALE = 0.02
TRAIN_STEPS = 4
# ssm_scan against ssm_scan_plain, both f32: max |difference| of y within
# 1e-5 of the largest |y| (and of hT within 1e-5 of the largest |hT|):
# both run the recurrence in the same order along T; the kernel's expf,
# its FMA for the state update and its butterfly sum over N round
# differently from the plain version's exp, mul/add and einsum
SSM_RTOL = 1e-5
# hybrid serving: the long prompt is longer than hymba's 1024-token window
# and a multiple of 64 (the chunked comparison then really chunks)
HYBRID_LONG_PROMPT = 1152
HYBRID_CACHE_LEN = 2048


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel(a, b) -> float:
    """Max-norm relative error of a against b (torch or numpy)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def ulp_at_max(want) -> float:
    """One bf16 ulp at the largest |want| element."""
    import math
    return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in units of a bf16 ulp of the magnitude
    (2^-7 of max(|want|, 1% of max |want|))."""
    want = want.float()
    scale = want.abs().clamp_min(float(want.abs().max()) * 1e-2)
    return float(((got.float() - want).abs() / scale).max()) * 2 ** 7


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of fn() on the card, each call fenced by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in ev)[reps // 2]


def graph_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Median ms of one fn() replayed from a CUDA graph that holds n calls
    back to back: the kernel's device time, without the host's work of
    each call between launches (cuda_ms times the call as a caller sees
    it, host work included)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return sorted(times)[reps // 2]


def main() -> None:
    t_start = time.perf_counter()
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
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.gpp import gpp_cuda, problem, ref
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.tune import measure, tuner

    # a fresh tune cache, so the main path tunes on this card
    tune_dir = os.path.join(ROOT, "build", "chip_smoke_tune")
    shutil.rmtree(tune_dir, ignore_errors=True)
    os.environ["REPRO_TUNE_CACHE"] = tune_dir
    dev = torch.device("cuda")
    spec = hw.spec_for_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 matmuls accumulate in f32 (the JAX package's
    # preferred_element_type), with no reduced-precision reductions
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    attrs = {c.name: gpp_cuda.kernel_attrs(c) for c in gpp_cuda.CONFIGS.values()}
    model = {c.name: c.regs_estimate() for c in gpp_cuda.CONFIGS.values()}
    print(f"[2] built {sorted(libs)} in {build_s:.1f} s; gpp compiled (regs, "
          f"spill bytes) per config: {attrs}; register table: {model}",
          flush=True)
    fattrs = {f"hd{hd}/q{bq}/kv{bkv}": flash_cuda.kernel_attrs(hd, bq, bkv)
              for hd in flash_cuda.HD_INSTANCES
              for bq in flash_cuda.BLK_Q_INSTANCES
              for bkv in flash_cuda.BLK_KV_INSTANCES}
    print(f"[2] flash_fwd compiled (regs, spill bytes) per instance: {fattrs}; "
          f"register table: {flash_cuda.REGS_BY_INSTANCE}", flush=True)
    battrs = {f"{kind}/hd{hd}/inner{inner}": flash_cuda.bwd_kernel_attrs(
        kind, hd, inner) for kind, inners in (
            ("dq", flash_cuda.DQ_BLK_KV_INSTANCES),
            ("dkv", flash_cuda.DKV_BLK_Q_INSTANCES))
        for hd in flash_cuda.HD_INSTANCES for inner in inners}
    print(f"[2] flash_bwd compiled (regs, spill bytes) per instance (dq: "
          f"inner = blk_kv; dkv: inner = blk_q): {battrs}; backward blocks "
          f"dq {flash_cuda.DQ_BLOCKS}, dkv {flash_cuda.DKV_BLOCKS}", flush=True)
    clusters = {f"hd{hd}/q{bq}/group{g}": flash_cuda.dkv_cluster_occupancy(
        hd, bq, g) for hd in flash_cuda.HD_INSTANCES
        for bq in flash_cuda.DKV_BLK_Q_INSTANCES for g in (1, 3, 5, 6, 8)}
    print(f"[2] flash_bwd_dkv clusters of `group` CTAs the card holds at "
          f"once (cudaOccupancyMaxActiveClusters): {clusters}", flush=True)
    sm90_line = sm90_checks(torch, dev)
    print(f"[2] sm90.cuh helpers alone: {sm90_line}", flush=True)
    sattrs = {f"n{n}/{'bf16' if bf else 'f32'}": ssm_cuda.kernel_attrs(n, bf)
              for n in ssm_cuda.N_INSTANCES for bf in (False, True)}
    print(f"[2] ssm_scan compiled (regs, spill bytes) per instance: {sattrs}",
          flush=True)

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
    counters = (gpp_cuda.gpp_fused, gpp_cuda.gpp_banded, flash_cuda.flash_fwd,
                flash_cuda.flash_bwd_dq, flash_cuda.flash_bwd_dkv,
                ssm_cuda.ssm_scan)

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
    print(f"[5] journey launches {by_path['journey']} [{card}]", flush=True)
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

    # -- 7. flash_fwd at op level --------------------------------------------
    zero_counts()
    flash_rows = flash_checks(torch, dev, spec, card, flash_cuda, flash_ref)
    torch.cuda.synchronize()
    by_path["flash-check"] = read_counts()

    # -- 7b. the backward kernels at op level ----------------------------------
    zero_counts()
    bwd_rows = flash_bwd_checks(torch, dev, spec, card, flash_cuda, flash_ref)
    torch.cuda.synchronize()
    by_path["bwd-check"] = read_counts()

    # -- 7c. the selective scan at op level -------------------------------------
    zero_counts()
    ssm_rows = ssm_checks(torch, dev, spec, card, ssm_cuda)
    torch.cuda.synchronize()
    by_path["ssm-check"] = read_counts()

    # -- 8. dense serving: qwen2-1.5b at full width through ServeEngine -------
    serve = serve_phase(torch, np, dev, card, flash_cuda, zero_counts,
                        read_counts, by_path)
    torch.cuda.empty_cache()

    # -- 10. training: qwen2-1.5b at full width through Trainer ---------------
    train = train_phase(torch, np, dev, spec, card, flash_cuda, zero_counts,
                        read_counts, by_path)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. hybrid serving: hymba-1.5b at full width through ServeEngine -----
    hybrid = hybrid_phase(torch, np, dev, card, ssm_cuda, zero_counts,
                          read_counts, by_path)

    names = ("gpp_fused", "gpp_banded", "flash_fwd", "flash_bwd_dq",
             "flash_bwd_dkv", "ssm_scan")
    launches = {name: {path: n[name] for path, n in by_path.items()}
                for name in names}
    f512 = flash_rows["s512"]
    kernels = [
        {"name": "gpp_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/gpp.cu",
         "replaces": "src/repro/kernels/gpp/pallas_gpp.py:219",
         "launches": launches["gpp_fused"]["dispatch"]
         + launches["gpp_fused"]["journey"],
         "launches_by_path": launches["gpp_fused"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "gpp_banded", "route": "cuda",
         "source": "src/repro_torch/csrc/gpp.cu",
         "replaces": "src/repro/kernels/gpp/pallas_gpp.py:192",
         "launches": launches["gpp_banded"]["dispatch"]
         + launches["gpp_banded"]["journey"],
         "launches_by_path": launches["gpp_banded"],
         "max_abs_err": banded["max_abs_err"], "ms": banded["ms"],
         "plain_ms": banded["plain_ms"], "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash.cu",
         "replaces": "src/repro/kernels/flash/flash.py:37",
         "launches": launches["flash_fwd"]["serve"],
         "launches_by_path": launches["flash_fwd"],
         "max_abs_err": f512["max_abs_err"], "ms": f512["ms"],
         "plain_ms": f512["plain_ms"], "bound_ms": f512["bound_ms"],
         "bound_by": f512["bound_by"], "library_ms": f512["library_ms"],
         "shape": f512["shape"], "at_s4096": flash_rows["s4096"],
         "at_train": flash_rows["train"]},
    ]
    for name, tpu in (("flash_bwd_dq", 142), ("flash_bwd_dkv", 179)):
        row = bwd_rows["train"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_bwd.cu",
            "replaces": f"src/repro/kernels/flash/flash.py:{tpu}",
            "launches": launches[name]["train"],
            "launches_by_path": launches[name], **row,
            "library_covers": "dq, dk and dv together (SDPA backward)",
            "shape": bwd_rows["train"]["shape"],
            "at_s4096": bwd_rows["s4096"][name]})
    row = ssm_rows["hymba-prefill"]
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm/ssm_scan.py:30",
        "launches": launches["ssm_scan"]["hybrid-serve"],
        "launches_by_path": launches["ssm_scan"],
        **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "shape", "blk_c")},
        "library_ms": None,
        "library_note": "no PyTorch call computes the selective scan",
        "at_t4096": ssm_rows["t4096"]})
    print(f"[8] serving summary: {json.dumps(serve)} [{card}]", flush=True)
    print(f"[10] training summary: {json.dumps(train)} [{card}]", flush=True)
    print(f"[11] hybrid serving summary: {json.dumps(hybrid)} [{card}]",
          flush=True)
    print(f"[9] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
          f"(build {build_s:.1f} s)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def sm90_checks(torch, dev) -> str:
    """Phase 2: the shared helpers of csrc/sm90.cuh on their own — one
    wgmma product for every operand mode, N and K against torch.matmul in
    f32 (products exact, only the summation order differs: within
    SM90_RTOL of the largest |product|), and TMA boxes of a contiguous and
    a strided (B, S, heads, Hd) tensor against slices (bit-equal)."""
    from repro_torch.kernels import sm90_check
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    for mode in sm90_check.MODES:
        for k in sm90_check.K_SIZES:
            for n in sm90_check.N_SIZES:
                a = torch.randn((64, k), generator=gen, device=dev).to(torch.bfloat16)
                b = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                want = a.float() @ b.float()
                got = sm90_check.wgmma_product(a, b, mode)
                err = float((got - want).abs().max() / want.abs().max())
                if err > SM90_RTOL:
                    fail(f"[2] wgmma {mode} n{n} k{k}: max-norm rel {err:.2e} "
                         f"(tol {SM90_RTOL})")
                worst = max(worst, err)
    boxes = 0
    for hd in (64, 128):
        x = torch.randn((2, 256, 3, hd), generator=gen, device=dev).to(torch.bfloat16)
        for t in (x, x.transpose(1, 2).contiguous().transpose(1, 2)):
            for rows, head, row0, b in ((64, 1, 64, 1), (128, 2, 128, 0)):
                if not torch.equal(sm90_check.tma_rows(t, rows, head, row0, b),
                                   t[b, row0:row0 + rows, head]):
                    fail(f"[2] TMA box ({rows} rows, head {head}, row {row0}, "
                         f"batch {b}) of {tuple(t.shape)} strides {t.stride()} "
                         f"differs from the slice")
                boxes += 1
    return (f"wgmma {len(sm90_check.MODES)} modes x N {sm90_check.N_SIZES} x "
            f"K {sm90_check.K_SIZES} vs torch.matmul f32, worst max-norm rel "
            f"{worst:.2e} (tol {SM90_RTOL}); {boxes} TMA boxes bit-equal to "
            f"their slices")


def flash_checks(torch, dev, spec, card, flash_cuda, flash_ref):
    """Phase 7: flash_fwd against flash_fwd_plain (and the f32 oracle at
    S=512); times, bound. Returns the rows keyed 's512' and 's4096' (the
    serving shape at the larger bucket, and the operations-bound size)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (("s256", 1, 256, 12, 2, 128, None),
             ("s512", 1, 512, 12, 2, 128, None),
             ("s4096", 1, 4096, 12, 2, 128, None),
             ("train", 8, 512, 12, 2, 128, None),
             ("mha512", 1, 512, 32, 32, 128, None),
             ("s512-q128-kv64", 1, 512, 12, 2, 128, (128, 64)))
    from repro_torch.kernels import api
    from repro_torch.tune import tuner
    rows = {}
    for tag, b, s, h, kvh, hd, blocks in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=dev
                               ).to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, kvh, hd),
                                 (b, s, kvh, hd)))
        if blocks is None:      # what the model path dispatches at this shape
            key = api.get_kernel("flash").problem_key(q, k, v)
            cfg = tuner.tune_kernel("flash", key, measure_mode=False,
                                    device=dev).config
        else:
            cfg = flash_cuda.FlashBlockConfig("check", *blocks)
        out, lse = flash_cuda.flash_fwd(q, k, v, cfg, True)
        torch.cuda.synchronize()
        p_out, p_lse = flash_cuda.flash_fwd_plain(q, k, v, cfg, True)
        torch.cuda.synchronize()
        ulps = bf16_ulps(out, p_out)
        lse_err = float((lse - p_lse).abs().max())
        max_abs = float((out.float() - p_out.float()).abs().max())
        line = (f"[7] flash_fwd {tag} (B={b}, S={s}, H={h}, KvH={kvh}, "
                f"Hd={hd}) blocks ({cfg.blk_q},{cfg.blk_kv}): out vs plain "
                f"max_abs {max_abs:.3e} = {ulps:.2f} bf16 ulps (tol "
                f"{FLASH_OUT_ULPS}), lse {lse_err:.2e} (tol {FLASH_LSE_ATOL})")
        if not (torch.isfinite(out.float()).all() and ulps <= FLASH_OUT_ULPS
                and lse_err <= FLASH_LSE_ATOL):
            fail(line)
        if tag == "s512":
            qp = q.transpose(1, 2).reshape(b * h, s, hd).float()
            kp = k.transpose(1, 2).reshape(b * kvh, s, hd).float()
            vp = v.transpose(1, 2).reshape(b * kvh, s, hd).float()
            want = flash_ref.reference(qp, kp, vp).reshape(b, h, s, hd
                                                           ).transpose(1, 2)
            r_ulps = bf16_ulps(out, want)
            line += f"; vs f32 ref.reference {r_ulps:.2f} ulps (tol {FLASH_OUT_ULPS})"
            if r_ulps > FLASH_OUT_ULPS:
                fail(line)
        ms = cuda_ms(lambda: flash_cuda.flash_fwd(q, k, v, cfg, True))
        dev_ms = graph_ms(lambda: flash_cuda.flash_fwd(q, k, v, cfg, True))
        plain_ms = cuda_ms(lambda: flash_cuda.flash_fwd_plain(q, k, v, cfg,
                                                              True), reps=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True))
        lib_dev_ms = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True))
        ops_ms = flash_cuda.useful_flops(b, h, s, s, hd, True) \
            / spec.bf16_tc_flops * 1e3
        bytes_ms = flash_cuda.min_bytes(b, h, kvh, s, s, hd) / spec.hbm_bw * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        line += (f"; kernel {ms:.4f} ms (device {dev_ms:.4f} ms from a CUDA "
                 f"graph), plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms "
                 f"(device {lib_dev_ms:.4f} ms); bound {bound:.4f} ms ({by}: "
                 f"{ops_ms:.4f} ms of bf16 at {spec.bf16_tc_flops / 1e12:.0f} "
                 f"TFLOP/s, {bytes_ms:.4f} ms of bytes) [{card}]")
        print(line, flush=True)
        rows[tag] = {"shape": [b, s, h, kvh, hd],
                     "blocks": [cfg.blk_q, cfg.blk_kv], "max_abs_err": max_abs,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms}
        if tag in ("s512", "s4096", "train"):
            rows[tag]["sweep"] = flash_sweep(torch, flash_cuda, q, k, v, cfg,
                                             tag, card)
    return rows


def flash_sweep(torch, flash_cuda, q, k, v, pick, tag, card):
    """Phase 7's model pick beside a timed sweep of the whole menu at one
    shape: each config's modeled ms and its device ms (graph_ms: at short
    S a call's host work hides the kernel), every one held against the
    plain version (FLASH_OUT_ULPS). Returns {"b_q x b_kv": device ms}."""
    from repro_torch.core import gpu_model
    from repro_torch.kernels import api
    kern = api.get_kernel("flash")
    key = kern.problem_key(q, k, v)
    timed = {}
    parts = []
    for cfg in kern.config_space(key, "cuda"):
        out, _ = flash_cuda.flash_fwd(q, k, v, cfg, True)
        p_out, _ = flash_cuda.flash_fwd_plain(q, k, v, cfg, True)
        ulps = bf16_ulps(out, p_out)
        if ulps > FLASH_OUT_ULPS:
            fail(f"[7] flash_fwd {tag} sweep ({cfg.blk_q},{cfg.blk_kv}): "
                 f"{ulps:.2f} bf16 ulps off the plain version")
        ms = graph_ms(lambda: flash_cuda.flash_fwd(q, k, v, cfg, True))
        name = f"{cfg.blk_q}x{cfg.blk_kv}"
        timed[name] = ms
        parts.append(f"{name} modeled {gpu_model.flash_step_s(key, cfg) * 1e3:.4f}"
                     f" ms, device {ms:.4f} ms")
    best = min(timed, key=timed.get)
    print(f"[7] flash_fwd {tag} model pick {pick.blk_q}x{pick.blk_kv} beside "
          f"the timed sweep: {'; '.join(parts)}; fastest on the device {best} "
          f"[{card}]", flush=True)
    return timed


def flash_bwd_checks(torch, dev, spec, card, flash_cuda, flash_ref):
    """Phase 7b: flash_bwd_dq and flash_bwd_dkv against their plain versions
    on the kernel forward's lse (and, at the training shape, the
    FlashAttention gradient against the f32 oracle); times, bounds.
    Returns the rows keyed by case, each with one entry per kernel."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(1)
    # blocks: None for bwd_configs, else ((dq's blk_q, blk_kv), (dkv's))
    cases = (("train", 8, 512, 12, 2, 128, None, True),
             ("s4096", 1, 4096, 12, 2, 128, None, True),
             ("mha512", 1, 512, 32, 32, 128, None, True),
             ("group3", 1, 512, 24, 8, 128, None, True),     # phi4-mini's heads
             ("group16", 1, 512, 16, 1, 128, None, True),    # f32 partials
             ("s512-dq64x32-dkv32x64", 1, 512, 12, 2, 128,
              ((64, 32), (32, 64)), True),
             ("s512-noncausal", 1, 512, 12, 2, 128, None, False))
    plain = {"flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}
    rows = {}
    for tag, b, s, h, kvh, hd, blocks, causal in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev
                                   ).to(torch.bfloat16)
                       for shape in ((b, s, h, hd), (b, s, kvh, hd),
                                     (b, s, kvh, hd), (b, s, h, hd)))
        out, lse = flash_cuda.flash_fwd(q, k, v, flash_cuda.FlashBlockConfig(),
                                        causal)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(
            b * h, s).contiguous()
        cfgs = (flash_cuda.bwd_configs(s, s) if blocks is None else
                tuple(flash_cuda.FlashBlockConfig("check", *bl)
                      for bl in blocks))
        kargs = {name: (q, k, v, do, lse, delta, c, causal)
                 for name, c in zip(plain, cfgs)}
        got = {"flash_bwd_dq": (flash_cuda.flash_bwd_dq(*kargs["flash_bwd_dq"]),),
               "flash_bwd_dkv": flash_cuda.flash_bwd_dkv(*kargs["flash_bwd_dkv"])}
        torch.cuda.synchronize()
        row = {"shape": [b, s, h, kvh, hd],
               "blocks": {name: [c.blk_q, c.blk_kv]
                          for name, c in zip(plain, cfgs)},
               "causal": causal}
        line = (f"[7b] {tag} (B={b}, S={s}, H={h}, KvH={kvh}, Hd={hd}, "
                f"{'causal' if causal else 'full'}) blocks dq "
                f"({cfgs[0].blk_q},{cfgs[0].blk_kv}) dkv ({cfgs[1].blk_q},"
                f"{cfgs[1].blk_kv}):")
        ok = True
        for name, outs in got.items():
            want = plain[name](*kargs[name])
            want = want if isinstance(want, tuple) else (want,)
            errs = [(float((g.float() - w.float()).abs().max()), ulp_at_max(w))
                    for g, w in zip(outs, want)]
            ok &= all(bool(torch.isfinite(g.float()).all()) for g in outs)
            ok &= all(e <= BWD_ULPS * u for e, u in errs)
            row[name] = {"max_abs_err": max(e for e, _ in errs),
                         "err_over_ulp_at_max": max(e / u for e, u in errs)}
            line += (f" {name} vs plain max_abs "
                     f"{[f'{e:.3e}' for e, _ in errs]} = "
                     f"{row[name]['err_over_ulp_at_max']:.2f} ulp at max "
                     f"(tol {BWD_ULPS});")
        if tag in ("train", "s4096"):
            again = flash_cuda.flash_bwd_dkv(*kargs["flash_bwd_dkv"])
            same = all(torch.equal(a, b_) for a, b_ in
                       zip(again, got["flash_bwd_dkv"]))
            ok &= same
            row["dkv_bit_equal_rerun"] = same
            line += f" flash_bwd_dkv bit-equal over two launches: {same};"
            del again
        if not ok:
            fail(line)
        if tag == "train":
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out2 = flash_cuda.flash_attention_diff(
                *leaves, flash_cuda.FlashBlockConfig(), causal)
            grads = torch.autograd.grad(out2, leaves, do)
            ref = [x.float().requires_grad_(True) for x in (q, k, v)]
            planar = [x.transpose(1, 2).reshape(-1, s, hd) for x in ref]
            r_out = flash_ref.reference(*planar, causal=causal).reshape(
                b, h, s, hd).transpose(1, 2)
            want = torch.autograd.grad(r_out, ref, do.float())
            rels = [float((g.float() - w).abs().max() / w.abs().max())
                    for g, w in zip(grads, want)]
            line += (f" FlashAttention grads vs f32 ref.reference, max-norm "
                     f"rel (dq, dk, dv) {[f'{r:.2e}' for r in rels]} (tol "
                     f"{BWD_REF_RTOL:.2e});")
            if max(rels) > BWD_REF_RTOL:
                fail(line)
            row["grad_vs_ref_rel"] = max(rels)
            del leaves, out2, grads, ref, planar, r_out, want
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        o_t = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o_t, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        for name, kern in (("flash_bwd_dq", flash_cuda.flash_bwd_dq),
                           ("flash_bwd_dkv", flash_cuda.flash_bwd_dkv)):
            kind = name.split("_")[-1]
            args = kargs[name]
            ms = cuda_ms(lambda: kern(*args))
            dev_ms = graph_ms(lambda: kern(*args))
            plain_ms = cuda_ms(lambda: plain[name](*args), reps=5, warmup=1)
            ops_ms = flash_cuda.bwd_useful_flops(b, h, s, s, hd, causal, kind) \
                / spec.bf16_tc_flops * 1e3
            bytes_ms = flash_cuda.bwd_min_bytes(b, h, kvh, s, s, hd, kind) \
                / spec.hbm_bw * 1e3
            bound = max(ops_ms, bytes_ms)
            by = "operations" if ops_ms >= bytes_ms else "bytes"
            row[name].update({"ms": ms, "device_ms": dev_ms,
                              "plain_ms": plain_ms, "bound_ms": bound,
                              "bound_by": by, "library_ms": lib_ms})
            line += (f" {name} {ms:.4f} ms (device {dev_ms:.4f} ms from a CUDA "
                     f"graph), plain {plain_ms:.3f} ms, bound "
                     f"{bound:.4f} ms ({by}: {ops_ms:.4f} ms of bf16, "
                     f"{bytes_ms:.4f} ms of bytes);")
        line += (f" sdpa backward (dq, dk, dv) {lib_ms:.4f} ms [{card}]")
        print(line, flush=True)
        rows[tag] = row
        del q, k, v, do, out, lse, delta, got, qt, kt, vt, o_t
    return rows


def ssm_inputs(torch, dev, b, t, c, n, seed, h0_scale):
    """The scan's operands as the model hands them over: x, dt, b, c f32
    (x, b, c ~ N(0, 1), dt = softplus(N(0, 1) - 2)), a_log = log(1..N) and
    d ~ N(0, 1) as bf16 params, h0 = h0_scale N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rnd(b, t, c)
    dt = torch.nn.functional.softplus(rnd(b, t, c) - 2)
    bm, cm = rnd(b, t, n), rnd(b, t, n)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev))[None].repeat(c, 1)
    d = rnd(c)
    h0 = h0_scale * rnd(b, c, n)
    return (x, dt, bm, cm, a_log.to(torch.bfloat16), d.to(torch.bfloat16), h0)


def ssm_errors(got, want):
    """(max |y diff| / max |y|, max |hT diff| / max |hT|, max |y diff|)."""
    (y, h), (py, ph) = got, want
    dy = float((y - py).abs().max())
    dh = float((h - ph).abs().max())
    return (dy / float(py.abs().max()), dh / max(float(ph.abs().max()), 1e-30),
            dy)


def ssm_checks(torch, dev, spec, card, ssm_cuda):
    """Phase 7c: ssm_scan against ssm_scan_plain; times, bound; at the
    prefill shape the blk_c sweep. Returns the rows keyed by case."""
    from repro_torch.kernels.ssm.kernel_def import SsmKey
    from repro_torch.tune import tuner
    cases = (("hymba-prefill", 1, HYBRID_LONG_PROMPT, 3200, 16, 0.0),
             ("t4096", 1, 4096, 3200, 16, 0.0),
             ("b4-t256", 4, 256, 3200, 16, 0.0),
             ("small-n8", 2, 100, 48, 8, 0.1),
             ("hymba-prefill-h0", 1, HYBRID_LONG_PROMPT, 3200, 16, 0.1))
    rows = {}
    for i, (tag, b, t, c, n, h0) in enumerate(cases):
        args = ssm_inputs(torch, dev, b, t, c, n, seed=10 + i, h0_scale=h0)
        key = SsmKey(b=b, t=t, c=c, n=n)
        # the blk_c the model path takes (mamba_path's model-only pick)
        cfg = tuner.tune_kernel("ssm", key, measure_mode=False,
                                device=dev).config
        got = ssm_cuda.ssm_scan(*args, cfg)
        torch.cuda.synchronize()
        want = ssm_cuda.ssm_scan_plain(*args, cfg)
        y_rel, h_rel, dy = ssm_errors(got, want)
        line = (f"[7c] ssm_scan {tag} (B={b}, T={t}, C={c}, N={n}, h0 "
                f"{h0}) blk_c {cfg.blk_c}: y vs plain max_abs {dy:.3e} = "
                f"{y_rel:.2e} of max |y|, hT {h_rel:.2e} of max |hT| (tol "
                f"{SSM_RTOL})")
        finite = bool(torch.isfinite(got[0]).all() and
                      torch.isfinite(got[1]).all())
        if not finite or max(y_rel, h_rel) > SSM_RTOL:
            fail(line)
        ms = cuda_ms(lambda: ssm_cuda.ssm_scan(*args, cfg))
        plain_ms = cuda_ms(lambda: ssm_cuda.ssm_scan_plain(*args, cfg),
                           reps=3, warmup=1)
        io = sum(x.numel() * x.element_size() for x in args + got)
        bytes_ms = io / spec.hbm_bw * 1e3
        ops_ms = ssm_cuda.useful_flops(b, t, c, n) / spec.fp32_flops * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
                 f"{bound:.4f} ms ({by}: {bytes_ms:.4f} ms of {io / 1e6:.2f} "
                 f"MB at {spec.hbm_bw / 1e12:.2f} TB/s, {ops_ms:.4f} ms of "
                 f"FP32 at {spec.fp32_flops / 1e12:.0f} TFLOP/s); no PyTorch "
                 f"call computes the scan [{card}]")
        print(line, flush=True)
        rows[tag] = {"shape": [b, t, c, n], "blk_c": cfg.blk_c,
                     "max_abs_err": dy, "y_rel": y_rel, "h_rel": h_rel,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by}
        if tag == "hymba-prefill":
            sweep = [(c_.blk_c, round(s_ * 1e3, 4),
                      round(cuda_ms(lambda c_=c_: ssm_cuda.ssm_scan(*args, c_)),
                            4))
                     for c_, s_ in tuner.rank_kernel("ssm", key, device=dev)]
            rows[tag]["sweep"] = sweep
            print(f"[7c] ssm_scan {tag}: every blk_c of the config space, "
                  f"(blk_c, modeled ms, measured ms) in the model's order: "
                  f"{sweep} [{card}]", flush=True)
        del args, got, want
    return rows


def hybrid_phase(torch, np, dev, card, ssm_cuda, zero_counts, read_counts,
                 by_path):
    """Phase 11: ServeEngine on hymba-1.5b at full width, ssm_impl "pallas"."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import Request, ServeEngine
    base = repro_torch.get_config("hymba-1.5b")
    cfg = dataclasses.replace(base, ssm_impl="pallas")
    t0 = time.perf_counter()
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=HYBRID_CACHE_LEN,
                      device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in SERVE_PROMPTS + (HYBRID_LONG_PROMPT,)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    # warm-up: one short request (cuBLAS handles, the library's first load)
    eng.run([Request(rid=99, prompt=prompts[0][:64], max_new_tokens=2)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats, decode_ms, admit_ms = drive(eng, reqs)
    torch.cuda.synchronize()
    by_path["hybrid-serve"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_pre = stats["prefills"]
    got = by_path["hybrid-serve"]
    line = (f"[11] serve hymba-1.5b (full width, {cfg.n_layers} layers, "
            f"{n_params / 1e9:.3f}e9 params, init {init_s:.1f} s), ssm_impl "
            f"'pallas': {stats['requests']} requests (prompts "
            f"{[len(p) for p in prompts]}), {n_pre} prefills, "
            f"{stats['decode_steps']} decode steps, {stats['new_tokens']} "
            f"tokens; launches {got} (ssm_scan expected {cfg.n_layers} x "
            f"{n_pre} = {cfg.n_layers * n_pre}) [{card}]")
    print(line, flush=True)
    others = {k: v for k, v in got.items() if k != "ssm_scan"}
    if (got["ssm_scan"] != cfg.n_layers * n_pre or n_pre != len(reqs)
            or any(others.values())):
        fail(line)
    check_outputs(eng, reqs, cfg.vocab_size)
    res = serve_metrics("11", stats, decode_ms, admit_ms, peak, len(reqs),
                        card)
    res["n_params"] = n_params

    # one admission round (the long prompt and three others) and three
    # decode rounds under torch.profiler
    zero_counts()
    profile_rounds(torch, "11", eng, [reqs[-1]] + reqs[1:6:2], res, card)
    torch.cuda.synchronize()
    by_path["hybrid-profile"] = read_counts()

    # the long prompt prefilled again, every ssm_scan launch held against
    # ssm_scan_plain on its own inputs
    errs = []

    def against_plain(args, out):
        errs.append(ssm_errors(out, ssm_cuda.ssm_scan_plain(*args)))

    zero_counts()
    with hold_launches(ssm_cuda, "ssm_scan", against_plain):
        first_token_logits(torch, eng, reqs[-1].prompt)
    torch.cuda.synchronize()
    by_path["hybrid-check"] = read_counts()
    worst_y = max(e[0] for e in errs)
    worst_h = max(e[1] for e in errs)
    line = (f"[11] {len(errs)} ssm_scan launches of one {HYBRID_LONG_PROMPT}-"
            f"token prefill held against ssm_scan_plain on their own inputs: "
            f"worst y {worst_y:.2e} of max |y|, hT {worst_h:.2e} of max |hT| "
            f"(tol {SSM_RTOL}); launches {by_path['hybrid-check']} [{card}]")
    print(line, flush=True)
    if len(errs) != cfg.n_layers or max(worst_y, worst_h) > SSM_RTOL:
        fail(line)
    res["launch_y_rel_max"], res["launch_h_rel_max"] = worst_y, worst_h

    # every prompt's first-token logits against the chunked scan
    zero_counts()
    chunked = ServeEngine(base, params, max_batch=4,
                          cache_len=HYBRID_CACHE_LEN, device=dev)
    rows = []
    for r in reqs:
        a = first_token_logits(torch, eng, r.prompt)
        c = first_token_logits(torch, chunked, r.prompt)
        rows.append((r.rid, len(r.prompt), logit_rel(a, c),
                     int(a.argmax() == c.argmax()),
                     bool(torch.isfinite(a).all())))
    torch.cuda.synchronize()
    by_path["hybrid-compare"] = read_counts()
    worst = max(x[2] for x in rows)
    line = (f"[11] first-token logits, ssm_impl 'pallas' against 'chunked' "
            f"(the chunked scan at T % 64 == 0, the sequential scan "
            f"otherwise), max |diff| / max |logit|: worst {worst:.3e} (tol "
            f"{SERVE_LOGIT_RTOL}); argmax agrees on "
            f"{sum(x[3] for x in rows)}/{len(rows)}; per request (rid, "
            f"prompt, rel): {[(x[0], x[1], round(x[2], 6)) for x in rows]}; "
            f"launches {by_path['hybrid-compare']} [{card}]")
    print(line, flush=True)
    if worst > SERVE_LOGIT_RTOL or not all(x[4] for x in rows):
        fail(line)
    res["logits_rel_vs_chunked"] = worst
    del eng, chunked, params
    return res


def _bits(t):
    """t's bit patterns as an integer tensor of the same width."""
    import torch
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.int8}
    return t.view(width[t.element_size()])


def train_phase(torch, np, dev, spec, card, flash_cuda, zero_counts,
                read_counts, by_path):
    """Phase 10: Trainer(...).run() on qwen2-1.5b at full width, flash on."""
    import dataclasses
    import math
    import repro_torch
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.dist.fault import resume_or_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import TrainLoopConfig, Trainer
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              use_flash_attention=True)
    n_layers = cfg.n_layers
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
    loop = TrainLoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
                           log_every=1, ckpt_dir=ckpt_dir)
    print(f"[10] train qwen2-1.5b (full width, {n_layers} layers, remat "
          f"{cfg.remat!r}, {cfg.optimizer}, flash on): seq_len "
          f"{loop.seq_len}, global_batch {loop.global_batch}, {TRAIN_STEPS} "
          f"steps; free disk under build/ {free_gb:.1f} GB", flush=True)
    tr = Trainer(cfg, loop, device=dev)
    step_ms, step_counts, save = [], [], {}
    real_step, real_write, real_save = tr.step_fn, tr.ckpt._write, tr.ckpt.save

    def timed_step(params, opt_state, batch):
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = real_step(params, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        step_counts.append({k: after[k] - before[k] for k in after})
        return out

    def timed_save(step, tree, **kw):
        t0 = time.perf_counter()
        real_save(step, tree, **kw)
        save["snapshot_s"] = time.perf_counter() - t0

    def timed_write(step, flat):
        t0 = time.perf_counter()
        real_write(step, flat)
        save["write_s"] = time.perf_counter() - t0

    tr.step_fn, tr.ckpt.save, tr.ckpt._write = timed_step, timed_save, timed_write
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = tr.run(verbose=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    by_path["train"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    v = cfg.vocab_size
    lse0 = math.log(v) + INIT_SCALE ** 2 * cfg.d_model / 2
    loss0 = lse0 + 1e-4 * lse0 ** 2
    per_step = {"gpp_fused": 0, "gpp_banded": 0, "flash_fwd": 2 * n_layers,
                "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers,
                "ssm_scan": 0}
    line = (f"[10] losses {[round(x, 4) for x in losses]} (step 0 expected "
            f"{loss0:.4f} +- {LOSS0_ATOL}); launches a step {step_counts} "
            f"(expected {per_step}); whole run {by_path['train']} [{card}]")
    print(line, flush=True)
    if (len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses)
            or abs(losses[0] - loss0) > LOSS0_ATOL
            or any(c != per_step for c in step_counts)
            or by_path["train"] != {k: n * TRAIN_STEPS
                                    for k, n in per_step.items()}):
        fail(line)
    tokens = loop.seq_len * loop.global_batch
    n_params = cfg.param_count()
    attn = 3 * n_layers * flash_cuda.useful_flops(
        loop.global_batch, cfg.n_heads, loop.seq_len, loop.seq_len,
        cfg.head_dim, True)
    steady = sorted(step_ms[1:])
    step_p50 = steady[len(steady) // 2]
    mfu = (6 * n_params * tokens + attn) / (step_p50 / 1e3) / spec.bf16_tc_flops
    step_dir = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:08d}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
    res = {"losses": losses, "step_ms": step_ms, "step_ms_p50": step_p50,
           "tokens_per_step": tokens, "tok_per_s": tokens / step_p50 * 1e3,
           "mfu": mfu, "model_flops_per_step": 6 * n_params * tokens + attn,
           "n_params": n_params, "peak_mem_gb": peak / 1e9, "run_s": run_s,
           "ckpt_gb": ckpt_bytes / 1e9, **save, "free_disk_gb": free_gb}
    print(f"[10] step ms {[round(x, 2) for x in step_ms]} (p50 after the "
          f"first {step_p50:.2f}); {res['tok_per_s']:.1f} tokens/s; mfu "
          f"{mfu:.4f} ((6 N tokens + attention {attn:.3e}) / step / "
          f"{spec.bf16_tc_flops / 1e12:.0f} TFLOP/s, N = {n_params}); peak "
          f"device memory {peak / 1e9:.2f} GB; checkpoint "
          f"{ckpt_bytes / 1e9:.2f} GB, snapshot {save.get('snapshot_s', 0):.2f} "
          f"s, write {save.get('write_s', 0):.2f} s [{card}]", flush=True)

    # the final checkpoint restored bit-equal to the state in memory
    t0 = time.perf_counter()
    step, restored = resume_or_init(tr.ckpt, lambda: None, device=dev)
    torch.cuda.synchronize()
    res["restore_s"] = time.perf_counter() - t0
    mine, back = tree_leaves(tr.state), tree_leaves(restored)
    same = (step == TRAIN_STEPS and len(mine) == len(back) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(_bits(a), _bits(b)) for a, b in zip(mine, back)))
    line = (f"[10] resume_or_init restored step {step} in "
            f"{res['restore_s']:.2f} s: {len(back)} leaves, bit-equal to the "
            f"{len(mine)} in memory: {same} [{card}]")
    print(line, flush=True)
    if not same:
        fail(line)
    del restored, back

    # one more step under torch.profiler
    src = TokenSource(DataConfig(seq_len=loop.seq_len,
                                 global_batch=loop.global_batch,
                                 vocab_size=v, seed=loop.seed))
    params, opt_state = tr.state["params"], tr.state["opt"]

    def batch_at(step):
        return {k: torch.from_numpy(a).to(dev)
                for k, a in src.batch_at(step).items()}

    zero_counts()
    batch = batch_at(TRAIN_STEPS)
    wall, busy, kernels, host, n_launch, ours = profile_window(
        torch, lambda: real_step(params, opt_state, batch))
    by_path["train-profile"] = read_counts()
    res["profile"] = {"wall_ms": wall, "device_busy_ms": busy,
                      "cuda_launch_kernel": n_launch, "own_kernels": ours}
    print(f"[10] profile one step: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({busy / wall:.1%}); cudaLaunchKernel {n_launch}; "
          f"the port's kernels (device ms, calls): {ours}; "
          f"top kernels (ms, calls): {kernels}; top host ops (self ms, "
          f"calls): {host} [{card}]", flush=True)

    # one more step with every backward launch held against its plain
    # version on its own inputs
    errs = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    plain = {"flash_bwd_dq": flash_cuda.flash_bwd_dq_plain,
             "flash_bwd_dkv": flash_cuda.flash_bwd_dkv_plain}

    def against_plain(name):
        def check(args, got):
            want = plain[name](*args)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            errs[name].append(max(
                float((g.float() - w.float()).abs().max()) / ulp_at_max(w)
                for g, w in pairs))
        return check

    zero_counts()
    with hold_launches(flash_cuda, "flash_bwd_dq",
                       against_plain("flash_bwd_dq")), \
            hold_launches(flash_cuda, "flash_bwd_dkv",
                          against_plain("flash_bwd_dkv")):
        real_step(params, opt_state, batch_at(TRAIN_STEPS + 1))
        torch.cuda.synchronize()
    by_path["train-check"] = read_counts()
    worst = {name: max(e) for name, e in errs.items()}
    line = (f"[10] one checked step: {len(errs['flash_bwd_dq'])} flash_bwd_dq "
            f"and {len(errs['flash_bwd_dkv'])} flash_bwd_dkv launches held "
            f"against their plain versions on their own inputs: worst "
            f"{worst} in bf16 ulps at the largest element (tol {BWD_ULPS}); "
            f"launches {by_path['train-check']} [{card}]")
    print(line, flush=True)
    if (len(errs["flash_bwd_dq"]) != n_layers
            or len(errs["flash_bwd_dkv"]) != n_layers
            or max(worst.values()) > BWD_ULPS):
        fail(line)
    res["bwd_launch_worst_ulps"] = worst
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr, params, opt_state
    return res


def drive(eng, reqs):
    """Submit every request at once and step the engine until it is idle.
    Returns (engine stats, sorted ms of the rounds without an admission,
    sorted ms of the rounds with one); each round ends on the host, after
    sampling."""
    eng.reset()
    for r in reqs:
        eng.submit(r, t_enqueue=eng._t_start)
    decode_ms, admit_ms = [], []
    while not eng.idle:
        t1 = time.perf_counter()
        rep = eng.step()
        dt = (time.perf_counter() - t1) * 1e3
        (admit_ms if rep.admitted else decode_ms).append(dt)
    return eng.finalize(), sorted(decode_ms), sorted(admit_ms)


def check_outputs(eng, reqs, vocab):
    """Every request got its max_new_tokens tokens, each in the vocabulary."""
    for r in reqs:
        toks = eng.outputs[r.rid]
        if len(toks) != r.max_new_tokens or not all(0 <= t < vocab
                                                    for t in toks):
            fail(f"request {r.rid}: {len(toks)} tokens, range "
                 f"[{min(toks)}, {max(toks)}]")


def serve_metrics(tag, stats, decode_ms, admit_ms, peak, n_reqs, card):
    """The serving metrics of one drive() run, printed and returned."""
    res = {"requests": stats["requests"], "prefills": stats["prefills"],
           "decode_steps": stats["decode_steps"],
           "new_tokens": stats["new_tokens"],
           "p50_ttft_ms": stats["p50_ttft_s"] * 1e3,
           "p99_ttft_ms": stats["p99_ttft_s"] * 1e3,
           "mean_ttft_ms": stats["mean_ttft_s"] * 1e3,
           "p50_tpot_ms": stats["p50_tpot_s"] * 1e3,
           "decode_step_ms_p50": decode_ms[len(decode_ms) // 2],
           "decode_step_ms_max": decode_ms[-1],
           "admit_step_ms_p50": admit_ms[len(admit_ms) // 2],
           "tok_per_s": stats["tok_per_s"], "wall_s": stats["wall_s"],
           "occupancy": stats["occupancy"], "peak_mem_gb": peak / 1e9}
    print(f"[{tag}] serve metrics: TTFT p50 {res['p50_ttft_ms']:.1f} ms, p99 "
          f"{res['p99_ttft_ms']:.1f} ms (all {n_reqs} submitted at once, "
          f"4 slots); decode step p50 {res['decode_step_ms_p50']:.2f} ms "
          f"({len(decode_ms)} steps without admissions); admission round p50 "
          f"{res['admit_step_ms_p50']:.2f} ms; TPOT p50 "
          f"{res['p50_tpot_ms']:.2f} ms; {res['tok_per_s']:.1f} tokens/s over "
          f"{res['wall_s']:.2f} s; occupancy {res['occupancy']:.3f}; peak "
          f"device memory {res['peak_mem_gb']:.2f} GB [{card}]", flush=True)
    return res


def profile_rounds(torch, tag, eng, reqs, res, card):
    """One admission round and three decode rounds of `reqs` (at most 8 new
    tokens each) under torch.profiler; the device-busy share into res."""
    from repro_torch.serve.engine import Request
    eng.reset()
    for r in reqs:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=8))
    for kind, n_steps in (("admit", 1), ("decode", 3)):
        wall, busy, kernels, host, _, ours = profile_window(
            torch, lambda: [eng.step() for _ in range(n_steps)])
        res[f"profile_{kind}"] = {"steps": n_steps, "wall_ms": wall,
                                  "device_busy_ms": busy, "own_kernels": ours}
        print(f"[{tag}] profile {kind} ({n_steps} step(s)): wall {wall:.2f} "
              f"ms, device busy {busy:.2f} ms ({busy / wall:.1%}); the port's "
              f"kernels (device ms, calls): {ours}; top kernels (ms, calls): "
              f"{kernels}; top host ops (self ms, calls): {host} [{card}]",
              flush=True)


def first_token_logits(torch, eng, prompt):
    """Logits of a prompt's first generated token through `eng`'s own
    admission path (bucket padding, prefill_into_slot) on a fresh cache."""
    plen = len(prompt)
    toks = torch.zeros((1, eng._bucket_len(plen, eng.cache_len)),
                       dtype=torch.long, device=eng.device)
    toks[0, :plen] = torch.as_tensor(prompt, device=eng.device)
    logits, _ = eng.model.prefill_into_slot(
        eng.params, eng._fresh_cache(), 0, {"tokens": toks}, plen)
    return logits[0, 0].float()


def serve_phase(torch, np, dev, card, flash_cuda, zero_counts, read_counts,
                by_path):
    """Phase 8: ServeEngine on qwen2-1.5b at full width, flash on."""
    import dataclasses
    import repro_torch
    from repro_torch.serve.engine import Request, ServeEngine
    base = repro_torch.get_config("qwen2-1.5b")
    cfg = dataclasses.replace(base, use_flash_attention=True)
    t0 = time.perf_counter()
    params = repro_torch.build_model(cfg).init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_batch=4, cache_len=1024, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
    hot = rng.integers(0, cfg.vocab_size, 200)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    reqs.append(Request(rid=len(prompts), prompt=hot, max_new_tokens=32,
                        temperature=0.8))
    # warm-up: one short request (cuBLAS handles, the flash tune pick)
    eng.run([Request(rid=99, prompt=prompts[0], max_new_tokens=2)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    stats, decode_ms, admit_ms = drive(eng, reqs)
    torch.cuda.synchronize()
    by_path["serve"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_pre = stats["prefills"]
    got = by_path["serve"]["flash_fwd"]
    line = (f"[8] serve qwen2-1.5b (full width, {cfg.n_layers} layers, "
            f"{n_params / 1e9:.3f}e9 params, init {init_s:.1f} s), flash on: "
            f"{stats['requests']} requests, {n_pre} prefills, "
            f"{stats['decode_steps']} decode steps, {stats['new_tokens']} "
            f"tokens; launches {by_path['serve']} (flash_fwd expected "
            f"{cfg.n_layers} x {n_pre} = {cfg.n_layers * n_pre}) [{card}]")
    print(line, flush=True)
    if got != cfg.n_layers * n_pre or n_pre != len(reqs):
        fail(line)
    if by_path["serve"]["gpp_fused"] or by_path["serve"]["gpp_banded"]:
        fail(line)
    check_outputs(eng, reqs, cfg.vocab_size)
    res = serve_metrics("8", stats, decode_ms, admit_ms, peak, len(reqs),
                        card)

    # where a step's time goes: one admission round (4 prefills at the
    # 256 and 512 buckets, then a decode) and three decode-only rounds,
    # each under torch.profiler
    zero_counts()
    profile_rounds(torch, "8", eng, reqs[1:8:2], res, card)
    torch.cuda.synchronize()
    by_path["profile"] = read_counts()

    # each prompt prefilled again through the flash engine (a), holding
    # every flash_fwd launch against flash_fwd_plain on the same inputs;
    # then through the same model with flash_fwd_plain in the kernel's
    # place (b) and through the chunked plain path (c)
    zero_counts()
    plain = ServeEngine(base, params, max_batch=4, cache_len=1024, device=dev)
    rows, launch_ulps = [], []

    def checked(run, q, k, v, **kw):
        out = run(q, k, v, **kw)
        want, _ = flash_cuda.flash_fwd_plain(q, k, v, flash_blocks(q, k, v, kw),
                                             kw["causal"])
        launch_ulps.append(bf16_ulps(out, want))
        return out

    def plain_in_place(run, q, k, v, **kw):
        return flash_cuda.flash_fwd_plain(q, k, v, flash_blocks(q, k, v, kw),
                                          kw["causal"])[0]

    for r in reqs:
        with route_flash(checked):
            a = first_token_logits(torch, eng, r.prompt)
        with route_flash(plain_in_place):
            b = first_token_logits(torch, eng, r.prompt)
        c = first_token_logits(torch, plain, r.prompt)
        rows.append((r.rid, len(r.prompt), logit_rel(a, b), logit_rel(a, c),
                     logit_rel(b, c), int(a.argmax() == b.argmax()),
                     int(a.argmax() == c.argmax()),
                     bool(torch.isfinite(a).all())))
    torch.cuda.synchronize()
    by_path["serve-check"] = read_counts()
    worst = {i: max(x[i] for x in rows) for i in (2, 3, 4)}
    line = (f"[8] {len(launch_ulps)} flash_fwd launches in {len(reqs)} "
            f"prefills held against flash_fwd_plain on their own inputs: "
            f"worst {max(launch_ulps):.2f} bf16 ulps (tol {FLASH_OUT_ULPS}); "
            f"first-token logits, max |diff| / max |logit|, worst: kernel path "
            f"vs plain version in its place {worst[2]:.3e}, kernel path vs "
            f"chunked {worst[3]:.3e} (tol {SERVE_LOGIT_RTOL} each), plain "
            f"version vs chunked {worst[4]:.3e}; argmax agrees on "
            f"{sum(x[5] for x in rows)}/{len(rows)} and "
            f"{sum(x[6] for x in rows)}/{len(rows)}; per request (rid, prompt, "
            f"a-b, a-c, b-c): "
            f"{[(x[0], x[1]) + tuple(round(e, 5) for e in x[2:5]) for x in rows]}"
            f"; launches {by_path['serve-check']} [{card}]")
    print(line, flush=True)
    if (len(launch_ulps) != cfg.n_layers * len(reqs)
            or max(launch_ulps) > FLASH_OUT_ULPS
            or max(worst[2], worst[3]) > SERVE_LOGIT_RTOL
            or not all(x[7] for x in rows)):
        fail(line)
    res["launch_ulps_max"] = max(launch_ulps)
    res["logits_rel_vs_plain"] = worst[2]
    res["logits_rel_vs_chunked"] = worst[3]
    return res


@contextlib.contextmanager
def hold_launches(module, name, check):
    """While open, module.<name> (a kernel wrapper) is a stand-in that calls
    the real wrapper, then check(args, result), and returns the result.
    The stand-in forwards `launches` to the real wrapper, which counts
    through its module-level name."""
    real = getattr(module, name)

    class Held:
        @property
        def launches(self):
            return real.launches

        @launches.setter
        def launches(self, n):
            real.launches = n

        def __call__(self, *args):
            out = real(*args)
            check(args, out)
            return out

    setattr(module, name, Held())
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def route_flash(fn):
    """While open, the flash descriptor's run(q, k, v, **kw) calls
    fn(run, q, k, v, **kw) with the real run."""
    from repro_torch.kernels import api
    fk = api.get_kernel("flash")
    run = fk.run
    fk.run = lambda q, k, v, **kw: fn(run, q, k, v, **kw)
    try:
        yield
    finally:
        del fk.run


def flash_blocks(q, k, v, kw):
    """The blocks the descriptor's run launches for these arguments."""
    from repro_torch.kernels import api
    from repro_torch.kernels.flash.flash_cuda import FlashBlockConfig
    key = api.get_kernel("flash").problem_key(q, k, v, causal=kw["causal"])
    return (kw["config"] or FlashBlockConfig()).clamped(key)


def logit_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def profile_window(torch, fn):
    """Run fn() under torch.profiler. Returns (wall ms, device-busy ms: the
    sum of the kernels' times, the 8 kernels with the most device time as
    (name, ms, calls), the 8 host ops with the most self CPU time as
    (name, ms, calls), the count of cudaLaunchKernel calls, and the port's
    own kernels (csrc/) as {name: (ms, calls)})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, host = [], []
    launches = 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels.append((e.key[:60], e.self_device_time_total / 1e3,
                            e.count))
        else:
            host.append((e.key[:40], e.self_cpu_time_total / 1e3, e.count))
            if e.key == "cudaLaunchKernel":
                launches = e.count
    busy = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    top_host = sorted(host, key=lambda k: -k[1])[:8]
    ours = {}
    for n, ms, c in kernels:
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "dkv_group_sum", "ssm_scan", "gpp"):
            if f"{name}_kernel" in n or (name == "gpp" and name in n):
                old = ours.get(name, (0.0, 0))
                ours[name] = (round(old[0] + ms, 3), old[1] + c)
    return (wall, busy, [(n, round(ms, 3), c) for n, ms, c in top],
            [(n, round(ms, 3), c) for n, ms, c in top_host], launches, ours)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
