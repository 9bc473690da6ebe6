#!/usr/bin/env python3
"""The selective scan, instruction by instruction, on an NVIDIA H100:
builds one or more versions of `csrc/ssm_scan.cu`, counts the SASS of each
one's step loop (`repro_torch.core.sass.loop_census` through
`ssm_cuda.census`) and, with --time, runs each at chip_smoke.py's phase-7c
cases in turns (A, B, ..., B, A), held to the same gates.

    python tools/ssm_scan_probe.py                      # the repo's kernel
    python tools/ssm_scan_probe.py \
        --kernel parent build/parent/src/repro_torch/csrc/ssm_scan.cu \
        --kernel new src/repro_torch/csrc/ssm_scan.cu --time --exp2

--kernel LABEL PATH names a source. A library that exports ssm_scan_run
is the repo's kernel (states a thread, launched through
`ssm_cuda.ssm_scan` under the model's pick for each case, or --config);
one that exports only ssm_scan_launch is the earlier kernel of one state
a thread, launched at blk_c = --parent-blk-c (clamped to a divisor of C).
--exp2 adds a version of the last --kernel whose decay() is
ex2.approx.ftz.f32 on dt times a prescaled by log2(e). Each version is
compiled with the flags of `repro_torch.kernels._build` into
build/ssm_probe/<label>/.

Per version it prints registers and spills of the N=16 bf16 instances and
the census of each (instructions an element by class, shuffles, the FMA
ratio, the issue bound at hymba-1.5b's prefill and at T=4096 on the SMs the
grid uses and on all of them, the MUFU bound); with --time, per case and
turn: y and hT against ssm_scan_plain (SSM_RTOL), bit-equal over two
launches, the distance of y and hT from a float64 run of ssm_scan_plain
on the same inputs (max |diff| / max |y64|, the plain f32 version's
beside it), the call's ms (CUDA events) and the device ms replayed from a
CUDA graph. Card machine only; exits 1 without a card or when a gate
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# ssm_scan.cu's decay_rate() and decay(), each from its signature to its
# closing brace, and their ex2.approx bodies
DECAY = re.compile(r"__device__ __forceinline__ float decay_rate\(float a\) "
                   r"\{.*?\n?\}\n+__device__ __forceinline__ float decay\("
                   r"float dt, float a\) \{.*?\n?\}", re.S)
EXP2_BODIES = (
    "__device__ __forceinline__ float decay_rate(float a) "
    "{ return a * 1.4426950408889634f; }\n\n"
    "__device__ __forceinline__ float decay(float dt, float a) {\n"
    "  float r;\n"
    "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(dt * a));\n"
    "  return r;\n"
    "}")


def build(label: str, source: str) -> str:
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "ssm_probe", label)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libssm_scan.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    return out


def one_state_launcher(lib, blk_c: int):
    """The launch of the one-state-a-thread kernel (its C interface:
    ssm_scan_launch(n, bf16, blk_c, 9 pointers, B, T, C, time_tile,
    stream)) under blk_c clamped to a divisor of C."""
    import torch
    from repro_torch.kernels.ssm import ssm_cuda
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [I, I, I] + [P] * 9 + [I] * 4 + [P]
    lib.ssm_scan_launch.restype = I

    def run(args, _cfg):
        x, dt, bm, cm, alog, d, h0 = args
        b, t, c = x.shape
        n = alog.shape[1]
        y = torch.empty_like(x)
        h = torch.empty_like(h0)
        rc = lib.ssm_scan_launch(
            n, int(alog.dtype == torch.bfloat16), ssm_cuda.div_clamp(blk_c, c),
            *(v.data_ptr() for v in (x, dt, bm, cm, alog, d, h0, y, h)),
            b, t, c, 64, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ssm_scan_launch failed: CUDA error {rc}")
        return y, h
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs=2, action="append",
                    metavar=("LABEL", "PATH"))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--exp2", action="store_true")
    ap.add_argument("--parent-blk-c", type=int, default=32)
    ap.add_argument("--config", nargs=2, type=int, metavar=("STATES", "BLK_C"),
                    help="run the repo-style versions at this config "
                         "instead of the model's pick")
    ap.add_argument("--dump", action="store_true",
                    help="write each step loop's SASS to "
                         "chiprun_out/ssm_loop_<label>_s<S>.sass and the "
                         "whole disassembly, with the encodings, to "
                         "chiprun_out/ssm_sass_<label>.txt")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    import chip_smoke as cs
    from repro_torch.core import hw, sass
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.kernels.ssm.kernel_def import SsmKey
    from repro_torch.kernels.ssm.ssm_cuda import SsmScanConfig
    from repro_torch.tune import tuner

    dev = torch.device("cuda")
    spec = hw.spec_for_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    versions = [tuple(k) for k in (args.kernel or [[
        "repo", os.path.join(ROOT, "src/repro_torch/csrc/ssm_scan.cu")]])]
    if args.exp2:
        label, path = versions[-1]
        text = open(path).read()
        if DECAY.search(text) is None:
            print(f"FAIL: {path} has no decay_rate()/decay() to replace",
                  flush=True)
            return 1
        variant = os.path.join(ROOT, "build", "ssm_probe", "ssm_scan_exp2.cu")
        os.makedirs(os.path.dirname(variant), exist_ok=True)
        with open(variant, "w") as f:
            f.write(DECAY.sub(lambda m: EXP2_BODIES, text, count=1))
        versions.append((f"{label}-exp2", variant))

    def pick(key):
        if args.config:
            return SsmScanConfig("probe", args.config[1],
                                 args.config[0]).clamped(key)
        return tuner.tune_kernel("ssm", key, measure_mode=False,
                                 device=dev).config

    shapes = {"hymba-prefill": SsmKey(1, cs.HYBRID_LONG_PROMPT, 3200, 16),
              "t4096": SsmKey(1, 4096, 3200, 16)}
    runners = {}
    for label, path in versions:
        lib = ctypes.CDLL(build(label, path))
        text, tool = sass.disassemble(os.path.join(
            ROOT, "build", "ssm_probe", label, "libssm_scan.so"))
        census = ssm_cuda.census(text)
        if args.dump:
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out",
                                   f"ssm_sass_{label}.txt"), "w") as f:
                f.write(text)
        if hasattr(lib, "ssm_scan_run"):
            ssm_cuda.bind(lib)
            runners[label] = lib
            attrs = {}
            for s in census:
                r, sp = ctypes.c_int(), ctypes.c_int()
                lib.ssm_func_attrs(16, s, 1, ctypes.byref(r), ctypes.byref(sp))
                attrs[s] = (r.value, sp.value)
        else:
            runners[label] = one_state_launcher(lib, args.parent_blk_c)
            r, sp = ctypes.c_int(), ctypes.c_int()
            lib.ssm_func_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
            lib.ssm_func_attrs(16, 1, ctypes.byref(r), ctypes.byref(sp))
            attrs = {1: (r.value, sp.value)}
        for s, c in sorted(census.items()):
            bounds = {}
            for tag, key in shapes.items():
                elems = key.b * key.t * key.c * key.n
                if s == 1:
                    blk = ssm_cuda.div_clamp(args.parent_blk_c, key.c)
                else:
                    ranked = [cfg for cfg, _ in tuner.rank_kernel(
                        "ssm", key, device=dev) if cfg.states == s]
                    blk = (pick(key).blk_c if args.config
                           and args.config[0] == s else ranked[0].blk_c)
                used = min(spec.sms, key.b * key.c // blk)
                bounds[tag] = {
                    "blk_c": blk, "sms": used,
                    "issue_ms": sass.issue_bound_s(
                        elems, c["instructions_per_element"], spec, used) * 1e3,
                    "issue_ms_all_sms": sass.issue_bound_s(
                        elems, c["instructions_per_element"], spec) * 1e3,
                    "mufu_ms": sass.mufu_bound_s(
                        elems, c["mufu_per_element"], spec, used) * 1e3}
            if args.dump:
                out = os.path.join(ROOT, "chiprun_out",
                                   f"ssm_loop_{label}_s{s}.sass")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                with open(out, "w") as f:
                    f.writelines(f"{a:05x}  {ins}\n" for a, ins in c["body"])
            per = {k: round(v, 3) for k, v in c["per_element"].items()}
            print(f"[census] {label} ({path}, {tool}): ssm_scan_kernel<16, "
                  f"S={s}, bf16> regs/spill {attrs.get(s)}; step loop "
                  f"{c['loop_instructions']} instructions for "
                  f"{c['elements_per_iteration']} (t, c, n) elements -> "
                  f"{c['instructions_per_element']:.3f} an element "
                  f"{json.dumps(per)}, SHFL {c['shfl_per_element']:.3f}; FMA "
                  f"ratio {c['fma_ratio']:.3f}; bounds {json.dumps(bounds)} "
                  f"[{card}]", flush=True)

    if not args.time:
        return 0
    order = [v[0] for v in versions] + [v[0] for v in reversed(versions)]
    ok = True
    times = {}
    for i, (tag, b, t, c, n, h0) in enumerate(cs.SSM_CASES):
        inputs = cs.ssm_inputs(torch, dev, b, t, c, n, seed=10 + i,
                               h0_scale=h0)
        key = SsmKey(b=b, t=t, c=c, n=n)
        cfg = pick(key)
        want = ssm_cuda.ssm_scan_plain(*inputs)
        y64, h64 = ssm_cuda.ssm_scan_plain(*inputs, dtype=torch.float64)
        plain64 = (cs.rel(want[0].double().cpu(), y64.cpu()),
                   cs.rel(want[1].double().cpu(), h64.cpu()))
        for label in order:
            run = runners[label]
            repo_style = isinstance(run, ctypes.CDLL)
            if repo_style:
                ssm_cuda._lib = lambda lib=run: lib

                def run(a, c_):
                    return ssm_cuda.ssm_scan(*a, c_)
            got = run(inputs, cfg)
            again = run(inputs, cfg)
            torch.cuda.synchronize()
            y_rel, h_rel, dy = cs.ssm_errors(got, want)
            same = all(bool(torch.equal(cs._bits(a), cs._bits(b_)))
                       for a, b_ in zip(got, again))
            d64 = (cs.rel(got[0].double().cpu(), y64.cpu()),
                   cs.rel(got[1].double().cpu(), h64.cpu()))
            ms = cs.cuda_ms(lambda: run(inputs, cfg))
            gms = cs.graph_ms(lambda: run(inputs, cfg))
            times.setdefault(tag, {}).setdefault(label, []).append(gms)
            good = max(y_rel, h_rel) <= cs.SSM_RTOL and same
            ok &= good
            used = (f"(states {cfg.states}, blk_c {cfg.blk_c})"
                    if repo_style else
                    f"(one state, blk_c "
                    f"{ssm_cuda.div_clamp(args.parent_blk_c, c)})")
            print(f"[time] {label} {tag} (B={b}, T={t}, C={c}, N={n}, h0 "
                  f"{h0}) {used}: "
                  f"call {ms:.4f} ms, device {gms:.4f} ms; vs plain y "
                  f"{y_rel:.2e} hT {h_rel:.2e} (tol {cs.SSM_RTOL}), rerun "
                  f"bit-equal {same}; from float64 y {d64[0]:.3e} hT "
                  f"{d64[1]:.3e} (plain f32: y {plain64[0]:.3e} hT "
                  f"{plain64[1]:.3e}) [{card}]", flush=True)
        del inputs, want, y64, h64
    print(f"[time] device ms per case and version (turns): "
          f"{json.dumps(times)}", flush=True)
    if not ok:
        print("FAIL: a version is off its plain version beyond SSM_RTOL or "
              "not bit-equal over two launches", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
