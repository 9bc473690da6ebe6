"""Build and load the port's CUDA sources at first use.

Each `csrc/*.cu` file is compiled by `nvcc` into a shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). Libraries land in `<repo>/build/repro_torch/`, named by a
hash of the source, every shared header (`csrc/*.cuh`, in sorted order)
and the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. What nvcc prints on a successful build (ptxas
warnings) is kept beside the library as `<name>.log`. Nothing is built when a module is
imported: the first kernel launch (or `load()`) builds.

Flags: sm_90a, -O3, and no --use_fast_math, so `1.0f / x` stays IEEE as
the reference's `1.0 / wdiffr` is.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile csrc/<source> unless the library for this exact source,
    headers and flags exists; returns the library's path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    if proc.stderr.strip():
        out.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, Path]:
    """Build every csrc/*.cu at once, one nvcc process each, started
    together."""
    sources = sorted(p.name for p in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {s: pool.submit(build, s) for s in sources}
        return {s: f.result() for s, f in futures.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of csrc/<source>, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LIBS[source] = lib
        return lib
