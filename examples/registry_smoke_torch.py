"""Registry smoke of the PyTorch port — the counterpart of
examples/registry_smoke.py: list the kernel registry and dispatch every
registered kernel at the reference's TINY keys, each against its "ref"
version (gpp against the complex128 oracle), at the reference's atols.
On the card (the default) that runs the hand-written kernels, and each
one's launches are printed; with --device cpu the plain versions.

    PYTHONPATH=src python examples/registry_smoke_torch.py
    PYTHONPATH=src python examples/registry_smoke_torch.py --device cpu

The keys are the reference's, except flash's head dim: 16 is below the
smallest the CUDA kernel is built for, so the flash key takes 32 (run on
the 64 instance, zero-padded). Exits nonzero if a family is missing, a
dispatch fails, or a kernel disagrees with its reference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import repro_torch
from repro_torch.kernels import api


def launches():
    """Every kernel wrapper's launch count, by name."""
    from repro_torch.kernels.flash import flash_cuda
    from repro_torch.kernels.gpp import gpp_cuda
    from repro_torch.kernels.paged import paged_cuda
    from repro_torch.kernels.ssm import ssm_cuda
    fns = (gpp_cuda.gpp_fused, gpp_cuda.gpp_banded, flash_cuda.flash_fwd,
           ssm_cuda.ssm_scan) + paged_cuda.ENTRY_POINTS
    return {f.__name__: f.launches for f in fns}


def check(name: str, outs, refs, atol: float) -> bool:
    err = max(float((torch.as_tensor(o).cpu().to(torch.complex128)
                     - torch.as_tensor(r).cpu().to(torch.complex128)
                     ).abs().max()) for o, r in zip(outs, refs))
    ok = err <= atol
    print(f"  {name}: {'ok' if ok else 'MISS'} (max |err| {err:.3g}, "
          f"atol {atol:.3g})", flush=True)
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = args.device
    names = repro_torch.list_kernels()
    print(f"registered kernels: {names}")
    ok = {"gpp", "flash", "ssm", "paged_decode"} <= set(names)
    before = launches()

    # gpp at TINY vs the complex128 oracle
    from repro_torch.kernels.gpp import problem, ref
    inputs = problem.make_inputs(problem.TINY)
    ar, xr = ref.ref_numpy(inputs)
    a, x = repro_torch.dispatch("gpp", inputs, device=dev)
    ok &= check("gpp v10@tiny", (a, x), (ar, xr),
                atol=1e-4 * float(np.max(np.abs(ar))))

    # flash + ssm: the default version against "ref", on tiny inputs from
    # each kernel's own make_example
    from repro_torch.kernels.flash.kernel_def import FlashKey
    fkey = FlashKey(b=2, h=4, kvh=2, sq=64, skv=64, hd=32)
    fargs, fkw = api.get_kernel("flash").make_example(fkey, device=dev)
    out = repro_torch.dispatch("flash", *fargs, device=dev, **fkw)
    out_ref = repro_torch.dispatch("flash", *fargs, version="ref",
                                   device=dev, **fkw)
    ok &= check("flash@64", (out,), (out_ref,), atol=2e-2)

    from repro_torch.kernels.ssm.kernel_def import SsmKey
    skey = SsmKey(b=2, t=32, c=8, n=4)
    sargs, _ = api.get_kernel("ssm").make_example(skey, device=dev)
    y, hT = repro_torch.dispatch("ssm", *sargs, device=dev)
    y_ref, hT_ref = repro_torch.dispatch("ssm", *sargs, version="ref",
                                         device=dev)
    ok &= check("ssm@32", (y, hT), (y_ref, hT_ref), atol=1e-3)

    # paged_decode: the block-table gather decode vs its oracle
    from repro_torch.kernels.paged.kernel_def import PagedKey
    pkey = PagedKey(b=2, h=2, kvh=2, page=16, npt=4, hd=32)
    pargs, pkw = api.get_kernel("paged_decode").make_example(pkey,
                                                             device=dev)
    pd = repro_torch.dispatch("paged_decode", *pargs, device=dev, **pkw)
    pd_ref = repro_torch.dispatch("paged_decode", *pargs, version="ref",
                                  device=dev, **pkw)
    ok &= check("paged_decode gather@16x4", (pd,), (pd_ref,), atol=1e-2)

    after = launches()
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    print(f"kernel launches: {ran}")
    if not ok:
        print("registry smoke: a kernel is missing or disagrees")
        sys.exit(1)
    print("registry smoke: all kernels dispatch and match their references")


if __name__ == "__main__":
    main()
