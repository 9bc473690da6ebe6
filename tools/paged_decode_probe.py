#!/usr/bin/env python3
"""Paged decode kernels side by side on an NVIDIA H100: builds one or more
versions of `csrc/paged_decode.cu` and times them in turns (A, B, ..., B,
A) at chip_smoke.py's phase-12b shapes, each held to its plain version
and measured against a float64 run of the same function.

    python tools/paged_decode_probe.py                  # the repo's kernel
    git archive <commit> src/repro_torch/csrc/paged_decode.cu \
        | tar -x -C build/parent
    python tools/paged_decode_probe.py \
        --kernel parent build/parent/src/repro_torch/csrc/paged_decode.cu \
        --kernel new src/repro_torch/csrc/paged_decode.cu \
        --p-parts 2 --loads-only --model

--kernel LABEL PATH names a source. A library that exports paged_occupancy
is the split kernel (launched through `paged_cuda` at the wrapper's split
count, or --splits); one without it is the earlier kernel of one CTA a
(row, kv head) with no split (its C interface has no part and splits
arguments), launched through `parent_kernel` at ppb 16. --p-parts N adds
a version of the last --kernel whose value product takes p as N bf16
parts (P_PARTS). --loads-only adds a version of the last --kernel whose
chunk loop scores nothing: it stages every page as the kernel does and
merges empty partials, so its time is the ring's loads, barriers, the
merge and the combine alone (its output is not checked). --model times
the repo's kernel at shapes outside the cases `gpu_model.paged_terms` was
fitted to (other head counts and dims, batch sizes and contexts), every
ppb of the menu at the wrapper's split count, beside the modeled time.
Each version is compiled with the flags of `repro_torch.kernels._build`
into build/paged_probe/<label>/, all at once.

Per case and version: the device ms of one call replayed from a CUDA graph
(chip_smoke.graph_ms), averaged over the turns; the bf16 ulps from the
plain version at the same split count; and the distance from a float64
run (`dense_f64`: max bf16 ulps and the RMS of the error), beside the
plain f32 version's own distance. Card machine only; exits 1 without a
card or when a checked version is more than PAGED_OUT_ULPS from its plain
version.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# the split kernel's chunk loop, and its loads-only form
CHUNK_LOOP = "for (int l0 = warp * CH; l0 < nl; l0 += WARPS * CH) {"
NO_CHUNKS = "for (int l0 = warp * CH; l0 < 0; l0 += WARPS * CH) {"
P_PARTS = re.compile(r"constexpr int P_PARTS = \d+;")
# (tag, version, B, Q, pages a row, cache_len, int8 pool, ppb)
CASES = (("decode", "gather", 4, 1, 64, (1024,) * 4, False, 16),
         ("int8", "int8", 4, 1, 64, (1024, 1000, 777, 517), True, 16),
         ("verify-bf16", "verify", 4, 4, 64, (1024, 1000, 777, 517), False,
          16),
         ("verify-int8", "verify", 4, 4, 64, (1024, 1000, 777, 517), True,
          16),
         ("empty-rows", "verify", 4, 4, 64, (0, 2, 1024, 17), False, 16),
         ("long", "gather", 8, 1, 512, (8192,) * 8, False, 4),
         ("long-int8", "int8", 8, 1, 512, (8192,) * 8, True, 4))
# shapes outside the model's fit: (tag, version, B, Q, H, KvH, Hd, pages a
# row, int8 pool), every row at its full context. The first six were
# measured before the model's chunk time took its Hd scaling; the last six
# after it
MODEL_CASES = (("hymba-decode", "gather", 4, 1, 25, 5, 64, 64, False),
               ("one-row-32k", "gather", 1, 1, 12, 2, 128, 2048, False),
               ("b16-2k", "gather", 16, 1, 12, 2, 128, 128, False),
               ("b32-4k-int8", "int8", 32, 1, 12, 2, 128, 256, True),
               ("verify-hd64", "verify", 8, 4, 8, 2, 64, 128, False),
               ("reduced-hd32", "verify", 4, 4, 4, 2, 32, 16, False),
               ("qwen2.5-32b-2k", "gather", 8, 1, 40, 8, 128, 128, False),
               ("phi4-verify", "verify", 4, 4, 24, 8, 128, 64, False),
               ("mha-hd64-int8", "int8", 8, 1, 12, 12, 64, 32, True),
               ("b2-16k", "gather", 2, 1, 12, 2, 128, 1024, False),
               ("b64-1k", "gather", 64, 1, 12, 2, 128, 64, False),
               ("hymba-verify-int8", "verify", 2, 4, 25, 5, 64, 256, True))


def build(label: str, source: str) -> str:
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "paged_probe", label)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libpaged_decode.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    return out


def variant(label: str, path: str, old, new: str) -> str:
    """A copy of `path` with `old` (a string or a compiled pattern, found
    exactly once) replaced by `new`, under build/paged_probe/."""
    text = open(path).read()
    hits = (len(old.findall(text)) if hasattr(old, "findall")
            else text.count(old))
    if hits != 1:
        raise RuntimeError(f"{path}: {hits} matches of {old!r}")
    out = os.path.join(ROOT, "build", "paged_probe", f"{label}.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(old.sub(new, text) if hasattr(old, "sub")
                else text.replace(old, new))
    return out


def parent_kernel(torch, lib):
    """The kernel of one CTA a (row, kv head), no split (its C interface
    without part and splits): a function (version, args, ppb) -> call, the
    launch on the current stream."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_gather_run.argtypes = [P] * 6 + [I] * 8 + [F, P]
    lib.paged_int8_run.argtypes = [P] * 8 + [I] * 8 + [F, P]
    lib.paged_verify_run.argtypes = [I] + [P] * 8 + [I] * 9 + [F, P]

    def make(version, args, ppb):
        q, kp, vp, tbl, cl, ks, vs = args
        b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
        qn = q.shape[1] if q.dim() == 4 else 1
        n_pages, page, kvh, _ = kp.shape
        tail = (b, h, kvh, hd, n_pages, page, tbl.shape[1], ppb, hd ** -0.5)
        out = torch.empty_like(q)
        ptr = (lambda x: None if x is None else x.data_ptr())

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            if version == "verify":
                rc = lib.paged_verify_run(
                    int(ks is not None), q.data_ptr(), kp.data_ptr(),
                    vp.data_ptr(), ptr(ks), ptr(vs), tbl.data_ptr(),
                    cl.data_ptr(), out.data_ptr(), b, qn, *tail[1:], stream)
            elif version == "int8":
                rc = lib.paged_int8_run(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
                    vs.data_ptr(), tbl.data_ptr(), cl.data_ptr(),
                    out.data_ptr(), *tail, stream)
            else:
                rc = lib.paged_gather_run(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    tbl.data_ptr(), cl.data_ptr(), out.data_ptr(), *tail,
                    stream)
            if rc != 0:
                raise RuntimeError(f"the parent kernel failed: CUDA error {rc}")
            return out
        return call
    return make


def dense_f64(torch, q, kp, vp, tbl, cl, ks, vs):
    """The paged decode function in float64 on the gathered K/V (an int8
    pool times its page scales): scores q.k Hd^-0.5, masked to -1e30
    where the line lies past the query's position, softmax, p v."""
    from repro_torch.kernels.paged import paged
    page = kp.shape[1]
    k = paged.gather_pages(kp, tbl).double()
    v = paged.gather_pages(vp, tbl).double()
    if ks is not None:
        k = k * ks.double()[tbl.long()].repeat_interleave(page, 1)[
            ..., None, None]
        v = v * vs.double()[tbl.long()].repeat_interleave(page, 1)[
            ..., None, None]
    q4 = (q[:, None] if q.dim() == 3 else q).double()
    qn, h, hd = q4.shape[1:]
    g = h // k.shape[2]
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,blhd->bhql", q4, k) * hd ** -0.5
    q_pos = cl.long()[:, None] - qn + torch.arange(qn, device=q.device)
    seen = torch.arange(k.shape[1], device=q.device) <= q_pos[..., None]
    s = torch.where(seen[:, None], s, torch.full_like(s, -1e30))
    out = torch.einsum("bhql,blhd->bqhd", torch.softmax(s, -1), v)
    return out[:, 0] if q.dim() == 3 else out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs=2, action="append",
                    metavar=("LABEL", "PATH"))
    ap.add_argument("--p-parts", type=int, default=None)
    ap.add_argument("--loads-only", action="store_true")
    ap.add_argument("--model", action="store_true")
    ap.add_argument("--splits", type=int, default=None,
                    help="split count of the split kernels (default: the "
                         "wrapper's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    import chip_smoke as cs
    from repro_torch.core import gpu_model, hw
    from repro_torch.kernels.paged import paged, paged_cuda
    from repro_torch.kernels.paged.kernel_def import (PPB_MENU, PagedBlockConfig,
                                                      PagedKey)

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    versions = [tuple(k) for k in (args.kernel or [[
        "repo", os.path.join(ROOT, "src/repro_torch/csrc/paged_decode.cu")]])]
    checked = {label: True for label, _ in versions}
    last_label, last_path = versions[-1]
    if args.p_parts is not None:
        label = f"{last_label}-p{args.p_parts}"
        versions.append((label, variant(
            label, last_path, P_PARTS,
            f"constexpr int P_PARTS = {args.p_parts};")))
        checked[label] = True
    if args.loads_only:
        label = f"{last_label}-loads"
        versions.append((label, variant(label, last_path, CHUNK_LOOP,
                                        NO_CHUNKS)))
        checked[label] = False

    entry = {"gather": paged_cuda.paged_decode_gather,
             "int8": paged_cuda.paged_decode_int8,
             "verify": paged_cuda.paged_decode_verify}
    plain = {"gather": paged.paged_decode_gather,
             "int8": paged.paged_decode_int8,
             "verify": paged.paged_decode_verify}
    libs, parents = {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(versions)) as pool:
        built = list(pool.map(lambda v: build(*v), versions))
    for (label, _), lib_path in zip(versions, built):
        lib = ctypes.CDLL(lib_path)
        if hasattr(lib, "paged_occupancy"):
            libs[label] = paged_cuda.bind(lib)
        else:
            parents[label] = parent_kernel(torch, lib)
    repo_lib = paged_cuda._lib

    def dist(got, exact):
        err = got.double() - exact
        return (round(cs.bf16_ulps(got, exact), 3),
                float(err.pow(2).mean().sqrt()))

    failed = False
    for i, (tag, version, b, qn, npt, clens, int8, ppb) in enumerate(CASES):
        a = cs.paged_inputs(torch, dev, b, qn, 12, 2, 128, cs.PAGED_PAGE, npt,
                            clens, 30 + i, int8)
        splits = args.splits or paged_cuda.splits_for(a[0], a[1], a[3])
        exact = dense_f64(torch, *a)
        plain_f32 = cs.paged_calls(entry, plain, version, a, ppb, splits)[1]()
        calls, ulps, far = {}, {}, {}
        for label, _ in versions:
            if label in parents:
                calls[label] = parents[label](version, a, 16)
                want = cs.paged_calls(entry, plain, version, a, 16, 1)[1]()
            else:
                lib = libs[label]
                paged_cuda._lib = lambda lib=lib: lib
                call, ref = cs.paged_calls(entry, plain, version, a, ppb,
                                           splits)
                calls[label] = (lambda call=call, lib=lib: (
                    setattr(paged_cuda, "_lib", lambda: lib), call())[1])
                want = ref()
            got = calls[label]()
            torch.cuda.synchronize()
            ulps[label] = cs.bf16_ulps(got, want)
            far[label] = dist(got, exact)
            if checked[label] and ulps[label] > cs.PAGED_OUT_ULPS:
                failed = True
        labels = [label for label, _ in versions]
        times = {label: [] for label in labels}
        for label in labels + labels[::-1]:
            times[label].append(cs.graph_ms(calls[label]))
        res = {label: (round(sum(t) / len(t), 4),
                       round(ulps[label], 2) if checked[label] else None,
                       far[label] if checked[label] else None)
               for label, t in times.items()}
        print(f"[probe] {tag} ({version}, B={b}, Q={qn}, {npt} pages a row, "
              f"ppb {ppb}, splits {splits}): (device ms, ulps from its "
              f"plain version, float64 distance (max ulps, rms)) {res}; the "
              f"plain f32 version's float64 distance {dist(plain_f32, exact)}"
              f" [{card}]", flush=True)
        del a, exact, plain_f32, calls
    paged_cuda._lib = repo_lib

    if args.model:
        spec = hw.spec_for_device(dev)
        errs = {"first six": [], "last six": []}
        for i, (tag, version, b, qn, h, kvh, hd, npt, int8) in enumerate(
                MODEL_CASES):
            ctx = npt * cs.PAGED_PAGE
            a = cs.paged_inputs(torch, dev, b, qn, h, kvh, hd, cs.PAGED_PAGE,
                                npt, (ctx,) * b, 60 + i, int8)
            key = PagedKey(b=b, h=h, kvh=kvh, page=cs.PAGED_PAGE, npt=npt,
                           hd=hd, qlen=qn)
            splits = paged_cuda.splits_for(a[0], a[1], a[3])
            row = {}
            for ppb in PPB_MENU:
                if npt % ppb:
                    continue
                call, ref = cs.paged_calls(entry, plain, version, a, ppb,
                                           splits)
                ulps = cs.bf16_ulps(call(), ref())
                if ulps > cs.PAGED_OUT_ULPS:
                    failed = True
                measured = cs.graph_ms(call)
                modeled = gpu_model.paged_step_s(
                    key, PagedBlockConfig("t", ppb).clamped(key),
                    1 if int8 else 2, spec, splits) * 1e3
                errs["first six" if i < 6 else "last six"].append(
                    modeled / measured - 1)
                row[ppb] = (round(measured, 4), round(modeled, 4),
                            round(ulps, 2))
            print(f"[probe-model] {tag} ({version}, B={b}, Q={qn}, H={h}, "
                  f"KvH={kvh}, Hd={hd}, {npt} pages a row, full; splits "
                  f"{splits}): by ppb (device ms, modeled ms, ulps from the "
                  f"plain version) {row} [{card}]", flush=True)
            del a
        for part, e in errs.items():
            print(f"[probe-model] modeled/device - 1 at the {part} shapes "
                  f"({len(e)} points outside the fit): max |.| "
                  f"{max(map(abs, e)):.3f}, rms "
                  f"{(sum(x * x for x in e) / len(e)) ** 0.5:.3f} [{card}]",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
