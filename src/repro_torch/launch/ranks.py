"""Start the ranks of a mesh on one host: one process a rank
(torch.multiprocessing spawn), each building its own Mesh over a
FileStore in a fresh temporary directory (no port to collide over).
examples/train_dp_torch.py, train_lm_torch.py and serve_batched_torch.py
start their ranks through it.

    from repro_torch.launch import ranks

    def rank_main(rank, store, args):
        mesh = ranks.rank_mesh(rank, store, ranks.mesh_shape(4, model=2),
                               device="cpu", backend="gloo")
        ...

    ranks.spawn(rank_main, 4, args)
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict

import torch


def mesh_shape(n_ranks: int, *, model: int = 1, pods: int = 1
               ) -> Dict[str, int]:
    """The mesh of `n_ranks`: {"data": n}, with {"pod": pods} before it
    when pods > 1 and {"model": model} after it when model > 1 (n =
    n_ranks / (pods x model))."""
    if n_ranks % (model * pods):
        raise ValueError(f"model {model} x pods {pods} does not divide "
                         f"{n_ranks} ranks")
    shape = {"data": n_ranks // (model * pods)}
    if pods > 1:
        shape = {"pod": pods, **shape}
    if model > 1:
        shape["model"] = model
    return shape


def rank_mesh(rank: int, store: str, shape: Dict[str, int], *, device: str,
              backend: str, timeout_s: float = 300.0):
    """This rank's Mesh of `shape` over the FileStore at `store` (the ranks
    of a card share it: each sets its CUDA device first)."""
    from repro_torch.launch.mesh import make_mesh
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    n = 1
    for v in shape.values():
        n *= v
    return make_mesh(shape, device=device, backend=backend,
                     init_method=f"file://{store}", rank=rank, world_size=n,
                     timeout_s=timeout_s)


def spawn(fn: Callable, n_ranks: int, *args, prefix: str = "ranks_"
          ) -> None:
    """Run fn(rank, store, *args) in `n_ranks` processes and wait for all
    of them (a rank that raises raises here); `store` is a FileStore path
    in a fresh temporary directory."""
    work = tempfile.mkdtemp(prefix=prefix)
    torch.multiprocessing.spawn(fn, args=(os.path.join(work, "store"),)
                                + args, nprocs=n_ranks)
