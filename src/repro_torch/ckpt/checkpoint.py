"""Checkpoints — the port of `repro.ckpt.checkpoint`, with the same
on-disk format, so that state moves between the two packages:

    <dir>/step_00000100/manifest.json    {step, leaves: {path: {shape, dtype}}}
    <dir>/step_00000100/data.npz         one entry per flattened leaf path
    <dir>/LATEST                         text file -> "step_00000100"

Leaves are flattened in sorted-key order to "a/b/c" paths (stored in the
npz with "\\x1f" for "/"). bf16 leaves are stored as their uint16 bit
patterns with "bfloat16" in the manifest, and read back bit for bit —
without ml_dtypes: out through `t.view(torch.int16)`, back through
`torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)`.

Fault-tolerance contract (the trainer relies on it):
  * a checkpoint is visible only after the atomic rename of its tmp dir
    and the LATEST pointer update (mkstemp + fsync + os.replace) — a host
    dying mid-save never corrupts state; `latest_step` also scans the
    directory, for a crash between the rename and the pointer update;
  * `save` copies the tree to host memory before it returns, so the
    caller may update its tensors in place at once; the write runs in a
    thread, and `barrier()` waits for it;
  * `restore(step, device=)` puts every leaf on `device`; the JAX
    package's `shardings=` (re-sharding onto a mesh) waits for the
    distribution slice.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend

Tree = Any


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict:
    root: Dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array to store, dtype name for the manifest): bf16 as its
    uint16 bit patterns, every other dtype as it is. Always a copy, also
    of a CPU tensor, so the caller may update t in place at once."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor a stored leaf holds (bf16 from its bit patterns)."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.asarray(a, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Tree, *, blocking: bool = False):
        """Snapshot to host memory synchronously, write to disk async."""
        flat = {k: to_numpy(v) for k, v in _flatten(tree).items()}
        self.barrier()
        if blocking:
            self._write(step, flat)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, flat), daemon=True)
            self._thread.start()

    def _write_guarded(self, step: int, flat):
        try:
            self._write(step, flat)
        except BaseException as e:       # re-raised by barrier()
            self._error = e

    def _write(self, step: int, flat: Dict[str, Tuple[np.ndarray, str]]):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp_{name}")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        store = {k.replace("/", "\x1f"): a for k, (a, _) in flat.items()}
        np.savez(os.path.join(tmp, "data.npz"), **store)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                       for k, (a, dt) in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic visibility
        self._write_latest(name)
        self._gc()

    def _write_latest(self, name: str):
        # mkstemp (unique name, same dir => same filesystem) + fsync +
        # os.replace: readers see either the old pointer or the new one,
        # never a partial write; latest_step() also falls back to a
        # directory scan for the rename-to-pointer crash window.
        fd, tmp_ptr = tempfile.mkstemp(dir=self.dir, prefix=".LATEST_",
                                       suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(name)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp_ptr, os.path.join(self.dir, "LATEST"))
        except BaseException:
            try:
                os.remove(tmp_ptr)
            except FileNotFoundError:
                pass
            raise

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def barrier(self):
        """Wait for the save in flight; raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        """Newest COMPLETE checkpoint step, or None: the LATEST pointer
        when it names a complete step directory, and a scan of the
        directory, for a crash between a step's rename and the pointer
        update."""
        candidates = []
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as fh:
                name = fh.read().strip()
            if self._complete(name):
                candidates.append(int(name.split("_")[1]))
        for d in os.listdir(self.dir):
            if d.startswith("step_") and self._complete(d):
                candidates.append(int(d.split("_")[1]))
        return max(candidates) if candidates else None

    def _complete(self, name: str) -> bool:
        """A step directory is complete iff it was atomically renamed into
        place with both its files (in-progress .tmp_ dirs never match)."""
        if not name.startswith("step_"):
            return False
        try:
            int(name.split("_")[1])
        except (IndexError, ValueError):
            return False
        d = os.path.join(self.dir, name)
        return (os.path.isdir(d)
                and os.path.exists(os.path.join(d, "manifest.json"))
                and os.path.exists(os.path.join(d, "data.npz")))

    def restore(self, step: Optional[int] = None, *,
                device=backend.DEFAULT_DEVICE) -> Optional[Tuple[int, Tree]]:
        """(step, tree) of the given (or latest) step with every leaf on
        `device` (the card unless device='cpu'); None when there is no
        checkpoint."""
        device = backend.resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        flat = {}
        with np.load(os.path.join(path, "data.npz")) as z:
            for key in z.files:
                k = key.replace("\x1f", "/")
                flat[k] = from_numpy(z[key], manifest["leaves"][k]["dtype"]
                                     ).to(device)
        return step, _unflatten(flat)
