#!/usr/bin/env python3
"""GPP's term, instruction by instruction, on an NVIDIA H100: builds one
or more versions of `csrc/gpp.cu`, counts the SASS of each one's band loop
(`repro_torch.core.sass`) and, with --time, times each at Si-214 in turns
(A, B, ..., B, A) under one block config and holds it to the GPP gates.

    python tools/gpp_term_probe.py                      # the repo's gpp.cu
    python tools/gpp_term_probe.py \
        --kernel parent build/parent/src/repro_torch/csrc/gpp.cu 3 \
        --kernel new src/repro_torch/csrc/gpp.cu 2 --time --rcp-approx

--kernel LABEL PATH RCP_PER_TERM names a source and how many reciprocals
one (ig, igp, band, iw) term takes in it (the census divides the loop by
that). --rcp-approx and --rcp-ieee each add a version of the last
--kernel whose `recip()` is rcp.approx.ftz.f32 plus one Newton step, or
IEEE 1.0f/x. Each version is compiled with the flags of
`repro_torch.kernels._build` into build/gpp_probe/<label>/.

Per version it prints registers and spills, the census of
gpp_fused_kernel<2, EPT, true> at the config's EPT (instructions a term by
class, the FMA ratio, the issue and MUFU bounds at Si-214) and, with
--time, the median of 5 CUDA-event-timed gpp_fused calls at Si-214 per
turn, the error against the plain version at BENCH (gate 1e-4) and
Si-214 (gate 5e-3), and chip_smoke.py's two distances: the BENCH totals
(ach, asx) from the complex128 oracle ref_numpy, and the Si-214 totals
from a float64 run of the plain version on the same inputs (max-norm
relative, the larger of ach and asx).
Card machine only; exits 1 without a card or when a gate fails.
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

TOL_PLAIN = {"bench": 1e-4, "si214": 5e-3}
# gpp.cu's recip(), from its signature to its closing brace
RECIP = re.compile(r"__device__ __forceinline__ float recip\(float x\) \{"
                   r".*?\n?\}", re.S)
RECIP_BODIES = {
    "ieee": "__device__ __forceinline__ float recip(float x) "
            "{ return 1.0f / x; }",
    "approx": "__device__ __forceinline__ float recip(float x) {\n"
              "  float r;\n"
              "  asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(x));\n"
              "  return r * (2.0f - x * r);\n"
              "}"}


def build(label: str, source: str) -> str:
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "gpp_probe", label)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libgpp.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs=3, action="append",
                    metavar=("LABEL", "PATH", "RCP_PER_TERM"))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--rcp-approx", action="store_true")
    ap.add_argument("--rcp-ieee", action="store_true")
    ap.add_argument("--dump", action="store_true",
                    help="write each band loop's SASS to "
                         "chiprun_out/gpp_loop_<label>.sass")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    from repro_torch.core import hw, sass
    from repro_torch.kernels.gpp import gpp_cuda, problem, ref
    from repro_torch.tune import measure

    dev = torch.device("cuda")
    spec = hw.spec_for_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kernels = args.kernel or [["repo", os.path.join(
        ROOT, "src/repro_torch/csrc/gpp.cu"), "2"]]
    versions = [(label, path, int(rcp)) for label, path, rcp in kernels]
    label, path, rcp = versions[-1]
    for kind in [k for k in ("approx", "ieee") if getattr(args, f"rcp_{k}")]:
        text = open(path).read()
        if RECIP.search(text) is None:
            print(f"FAIL: {path} has no recip() to replace", flush=True)
            return 1
        variant = os.path.join(ROOT, "build", "gpp_probe", f"gpp_rcp_{kind}.cu")
        os.makedirs(os.path.dirname(variant), exist_ok=True)
        with open(variant, "w") as f:
            f.write(RECIP.sub(lambda m: RECIP_BODIES[kind], text, count=1))
        versions.append((f"{label}-rcp-{kind}", variant, rcp))

    cfg = gpp_cuda.BlockConfig("tuned", 16, 32, 128, aqsm_transposed=True,
                               fused_acc=True, threads=512)
    size = problem.SI214
    libs = {}
    for label, path, rcp in versions:
        lib = gpp_cuda.bind(ctypes.CDLL(build(label, path)))
        libs[label] = lib
        gpp_cuda._lib = lambda lib=lib: lib
        regs = gpp_cuda.kernel_attrs(cfg)
        text, tool = sass.disassemble(os.path.join(
            ROOT, "build", "gpp_probe", label, "libgpp.so"))
        pattern = rf"gpp_fused_kernelILi2ELi{cfg.ept_instance()}ELb1E"
        c = sass.term_census(text, pattern, rcp)
        if args.dump:
            (name, instrs), = ((n, i) for n, i in sass.functions(text).items()
                               if pattern in n)
            out = os.path.join(ROOT, "chiprun_out", f"gpp_loop_{label}.sass")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as f:
                f.writelines(f"{a:05x}  {ins}\n"
                             for a, ins in sass.innermost_loop(instrs))
        issue = sass.issue_bound_s(size.inner_iters,
                                   c["instructions_per_term"], spec)
        mufu = sass.mufu_bound_s(size.inner_iters, c["mufu_per_term"], spec)
        print(f"[census] {label} ({path}, {tool}): gpp_fused EPT "
              f"{cfg.ept_instance()} regs/spill {regs}; band loop "
              f"{c['loop_instructions']} instructions, "
              f"{c['terms_per_iteration']} terms an iteration -> "
              f"{c['instructions_per_term']:.2f} a term "
              f"{json.dumps({k: round(v, 2) for k, v in c['per_term'].items()})}"
              f", {c['fast_path_per_term']:.2f} without the slow-path call "
              f"stubs; FMA ratio {c['fma_ratio']:.3f}; at Si-214 issue bound "
              f"{issue * 1e3:.3f} ms ({sass.issue_bound_s(size.inner_iters, c['fast_path_per_term'], spec) * 1e3:.3f} "
              f"ms on the fast path), MUFU bound {mufu * 1e3:.3f} ms "
              f"[{card}]", flush=True)

    if not args.time:
        return 0
    t = {s.name: problem.to_tensors(problem.make_inputs(s), dev)
         for s in (problem.BENCH, size)}
    want = {s.name: gpp_cuda.gpp_fused_plain(t[s.name], cfg.clamped(s))
            for s in (problem.BENCH, size)}
    p64 = gpp_cuda.gpp_fused_plain({k: v.double() for k, v in t["si214"].items()},
                                   cfg).sum((0, 1)).cpu().numpy()
    oracle = ref.ref_numpy(problem.make_inputs(problem.BENCH))

    def distance(tot, want):
        """max over (ach, asx) of max |got - want| / max |want|"""
        tot = tot.double().cpu().numpy()
        return max(float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
                   for g, w in ((tot[0] + 1j * tot[1], want[0]),
                                (tot[2] + 1j * tot[3], want[1])))
    ok = True
    order = [v[0] for v in versions] + [v[0] for v in reversed(versions)]
    times = {label: [] for label in libs}
    for label in order:
        gpp_cuda._lib = lambda lib=libs[label]: lib
        errs, tots = {}, {}
        for s in (problem.BENCH, size):
            got = gpp_cuda.gpp_fused(t[s.name], cfg.clamped(s))
            w = want[s.name]
            errs[s.name] = float((got - w).abs().max() / w.abs().max())
            ok &= errs[s.name] <= TOL_PLAIN[s.name]
            tots[s.name] = got.sum((0, 1))
        c128 = distance(tots["bench"], oracle)
        f64 = distance(tots["si214"], (p64[0] + 1j * p64[1],
                                       p64[2] + 1j * p64[3]))
        ms = measure.time_callable(lambda: gpp_cuda.gpp_fused(t["si214"], cfg),
                                   device=dev, warmup=1, reps=5) * 1e3
        times[label].append(ms)
        print(f"[time] {label}: gpp_fused si214 {ms:.3f} ms "
              f"({size.total_flops() / ms / 1e9:.3f} TFLOP/s); vs plain "
              f"max-norm rel bench {errs['bench']:.2e} (tol "
              f"{TOL_PLAIN['bench']}), si214 {errs['si214']:.2e} (tol "
              f"{TOL_PLAIN['si214']}); bench totals vs complex128 "
              f"{c128:.3e}; si214 totals vs float64 {f64:.3e} [{card}]",
              flush=True)
    print(f"[time] per version (turns): {json.dumps(times)}", flush=True)
    if not ok:
        print("FAIL: a version is off its plain version beyond a gate",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
