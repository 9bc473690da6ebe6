"""Meshes for explicit SPMD: one process a mesh rank — the port of
`repro.launch.mesh` (:14-27).

The JAX package builds a `jax.sharding.Mesh` over the devices one
program sees, and GSPMD splits the work. Here every rank is its own
process (`torch.distributed`), holds only its local shards
(dist/sharding.local_shard) and talks to the others through the process
group of each mesh axis. A `Mesh` records:

  * `shape`: an ordered name -> size mapping, the one thing the sharding
    engine reads (as JAX's `mesh.shape`);
  * `axis_names`, this rank's `rank` and `coords` (name -> index; ranks
    are laid out rank-major in the order of `shape`, the last axis the
    fastest, as `jax.make_mesh` lays out devices);
  * `group(axes)`: the process group of one axis (a name) or of several
    (a tuple of names): the world for a one-axis mesh or for axes that
    cover every rank; a `DeviceMesh`'s `get_group(name)` for one axis of
    more; for the data axes ("pod", "data") beside a third axis larger
    than 1, the subgroup `make_mesh` built for this rank's other
    coordinates (`axes_groups`: one a model coordinate, members in
    rank order);
  * `device` (where this rank's tensors live) and `backend`.

The caller chooses the backend ("gloo" or "nccl"); `make_mesh` prints it
and never picks one. NCCL needs a GPU a rank; two ranks sharing one card
talk over gloo, which takes CUDA tensors (a collective then passes through
host memory inside gloo). A mesh of one rank needs no process group: its
gathers and reductions are the identity.

`abstract_mesh(shape, rank)` is a rank's view of a mesh that no process
runs: backend "abstract", no process group, `group()` the axes' names.
Its AxesGroups count every collective and return an empty tensor of the
result's shape (dist/collectives.py), so a step can be called on fake
tensors as one rank of a production mesh (analyze.census.census_step,
launch/dryrun.py) without a world.

    # CPU, 2 processes, each running:
    mesh = make_mesh({"model": 2}, device="cpu", backend="gloo",
                     init_method=f"file://{path}", rank=rank, world_size=2)
"""

from __future__ import annotations

import datetime
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

# the data axes of a training mesh, outer first (train/step.make_plan's
# plans split the batch and FSDP's leaves over those the mesh has)
DATA_AXES = ("pod", "data")
# the backend of a mesh that no process runs (abstract_mesh)
ABSTRACT = "abstract"


def axes_groups(shape: Mapping[str, int], axes: Sequence[str]
                ) -> List[Tuple[int, ...]]:
    """Every group of ranks of a mesh of `shape` (name -> size, ranks
    rank-major, the last axis the fastest, as `jax.make_mesh` lays out
    devices) that differ only in their `axes` coordinates: one group for
    each coordinate of the other axes, in rank order, each group's
    members in rank order (for `axes` in the mesh's order, a member's
    place is its `axes` coordinates as one mixed-radix number, the first
    axis the most significant). A pure function of the layout, the same
    on every rank: torch.distributed needs every rank to build every
    subgroup, in the same order."""
    names = tuple(shape)
    missing = [a for a in axes if a not in shape]
    if missing:
        raise ValueError(f"axes {missing} not in the mesh {dict(shape)}")
    ids = torch.arange(math.prod(int(n) for n in shape.values())).reshape(
        tuple(int(n) for n in shape.values()))
    inner = [names.index(a) for a in axes]
    outer = [i for i in range(len(names)) if i not in inner]
    size = math.prod(int(shape[a]) for a in axes)
    rows = ids.permute(outer + inner).reshape(-1, size)
    return [tuple(int(r) for r in row) for row in rows]


def axes_members(shape: Mapping[str, int], axes: Sequence[str],
                 rank: int) -> Tuple[int, ...]:
    """The group of `axes_groups(shape, axes)` that holds `rank`."""
    for members in axes_groups(shape, axes):
        if rank in members:
            return members
    raise ValueError(f"rank {rank} outside a mesh of {dict(shape)}")


def subgroup_axes(shape: Mapping[str, int]) -> List[Tuple[str, ...]]:
    """The groups over more than one axis that `make_mesh` builds for a
    mesh of `shape`: the data axes ("pod", "data") where both are larger
    than 1 and another axis is too (where they cover every rank, their
    group is the world)."""
    data = tuple(a for a in shape if a in DATA_AXES)
    big = [a for a in data if int(shape[a]) > 1]
    rest = math.prod(int(n) for a, n in shape.items() if a not in data)
    return [data] if len(big) > 1 and rest > 1 else []


class Mesh:
    """A rank's view of a logical device mesh (see the module docstring).
    Build one with make_mesh."""

    def __init__(self, shape: Mapping[str, int], *, rank: int, device,
                 backend: str, groups: Optional[Dict[str, object]] = None):
        self.shape: Dict[str, int] = {k: int(v) for k, v in shape.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self._groups = dict(groups or {})
        # rank-major: the last axis the fastest
        coords, r = {}, rank
        for name in reversed(self.axis_names):
            r, coords[name] = divmod(r, self.shape[name])
        self.coords: Dict[str, int] = {n: coords[n] for n in self.axis_names}

    def group(self, axes: Union[str, Sequence[str]]):
        """The process group over `axes` (a name or a tuple of names; None
        where they hold one rank, and no collective is needed): one axis's
        group, the world where they cover every rank, else the subgroup
        make_mesh built for them (`subgroup_axes`)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        big = tuple(a for a in self.axis_names
                    if a in names and self.shape[a] > 1)
        if not big:
            return None
        if self.backend == ABSTRACT:
            return big                    # no process group: the names
        if len(big) == 1:
            return self._groups[big[0]]
        if math.prod(self.shape[a] for a in big) == self.size:
            import torch.distributed as dist
            return dist.group.WORLD
        if big not in self._groups:
            raise ValueError(f"no process group over {big} of mesh "
                             f"{self.shape}: make_mesh builds "
                             f"{subgroup_axes(self.shape)}")
        return self._groups[big]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device}, "
                f"backend={self.backend!r})")


def make_mesh(shape: Union[Mapping[str, int], Sequence[int]],
              axes: Optional[Sequence[str]] = None, *, device,
              backend: str, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout_s: float = 300.0) -> Mesh:
    """This rank's Mesh of `shape` (a name -> size mapping, or sizes with
    `axes` naming them), its tensors on `device`, collectives over
    `backend`.

    A mesh of more than one rank needs torch.distributed: if no process
    group exists yet, one is initialized here from `init_method`
    ("file://<path>" for a FileStore: no port to collide over; or
    "tcp://localhost:<port>"), `rank` and `world_size`, with a timeout of
    `timeout_s` so a rendezvous or collective that hangs fails instead. An
    existing group must use `backend` and have the mesh's size. A mesh of
    one rank needs none. Every rank builds each axis's group and the
    subgroups of `subgroup_axes` (all of them, in one order; a rank keeps
    its own). The backend and the layout are printed."""
    if not isinstance(shape, Mapping):
        if axes is None or len(axes) != len(shape):
            raise ValueError(f"sizes {tuple(shape)} need one name each, got "
                             f"axes {axes}")
        shape = dict(zip(axes, shape))
    elif axes is not None and tuple(axes) != tuple(shape):
        raise ValueError(f"axes {tuple(axes)} differ from the shape's "
                         f"{tuple(shape)}")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: choose 'gloo' or 'nccl'")
    size = 1
    for n in shape.values():
        size *= int(n)
    import torch.distributed as dist
    if size == 1 and not dist.is_initialized():
        mesh = Mesh(shape, rank=0, device=device, backend=backend)
        print(f"[mesh] {dict(mesh.shape)}: 1 rank, backend {backend} (no "
              f"collective needed), device {mesh.device}", flush=True)
        return mesh
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("a mesh of several ranks needs init_method=, "
                             "rank= and world_size= (or an initialized "
                             "torch.distributed)")
        if init_method.startswith("file://"):
            store = dist.FileStore(init_method[len("file://"):], world_size)
            dist.init_process_group(
                backend, store=store, rank=rank, world_size=world_size,
                timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.init_process_group(
                backend, init_method=init_method, rank=rank,
                world_size=world_size,
                timeout=datetime.timedelta(seconds=timeout_s))
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"torch.distributed runs {have!r}, the mesh asks "
                         f"for {backend!r}")
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {dict(shape)} has {size} ranks, the world "
                         f"{dist.get_world_size()}")
    names = tuple(shape)
    if len(names) == 1:
        groups = {names[0]: dist.group.WORLD}
    else:
        from torch.distributed.device_mesh import DeviceMesh
        # the DeviceMesh only builds the axes' groups; "cpu" keeps it from
        # binding a CUDA device a rank when ranks share a card over gloo
        dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                        torch.arange(size).reshape(tuple(shape.values())),
                        mesh_dim_names=names)
        groups = {n: dm.get_group(n) for n in names}
        rank = dist.get_rank()
        for axes in subgroup_axes(shape):
            for members in axes_groups(shape, axes):
                g = dist.new_group(list(members), timeout=datetime.timedelta(
                    seconds=timeout_s))
                if rank in members:
                    groups[axes] = g
    mesh = Mesh(shape, rank=dist.get_rank(), device=device, backend=backend,
                groups=groups)
    print(f"[mesh] {dict(mesh.shape)}: rank {mesh.rank} of {size} at "
          f"{mesh.coords}, backend {backend}, device {mesh.device}",
          flush=True)
    return mesh


def abstract_mesh(shape: Mapping[str, int], rank: int = 0) -> Mesh:
    """Rank `rank`'s view of a mesh of `shape` that no process runs: the
    backend ABSTRACT, tensors on the CPU, no process group (`group()`
    gives the axes' names). Collectives over it are counted and return
    empty tensors of their results' shapes (dist.collectives.AxesGroup),
    so a step runs on fake tensors as that rank would run it.

    Example::

        from repro_torch.launch.mesh import abstract_mesh
        m = abstract_mesh({"data": 16, "model": 16}, rank=17)
        m.coords, m.group("model")    # {'data': 1, 'model': 1} ('model',)
    """
    return Mesh(shape, rank=rank, device="cpu", backend=ABSTRACT)


def make_debug_mesh(model: int = 4, data: int = 2, *, multi_pod: bool = False,
                    device, backend: str, **init) -> Mesh:
    """Small mesh for tests: (data, model), or (2, data, model) over
    ("pod", "data", "model") with multi_pod. `init` as make_mesh's."""
    if multi_pod:
        return make_mesh({"pod": 2, "data": data, "model": model},
                         device=device, backend=backend, **init)
    return make_mesh({"data": data, "model": model}, device=device,
                     backend=backend, **init)


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The JAX package's production layouts: one pod (16, 16) over
    ("data", "model"), 256 ranks; multi-pod (2, 16, 16) over ("pod",
    "data", "model"), 512 ranks."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False, device, backend: str,
                         **init) -> Mesh:
    """This rank's Mesh of `production_shape(multi_pod)`. `init` as
    make_mesh's (launch/dryrun.py counts one rank of it on an
    abstract_mesh instead)."""
    return make_mesh(production_shape(multi_pod), device=device,
                     backend=backend, **init)
