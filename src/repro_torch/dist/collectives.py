"""Collectives over the ranks of some mesh axes, for explicit SPMD: the
port's stand-ins for the `psum`, `pmax`, `all_gather`, `psum_scatter`,
`all_to_all` and `ppermute` that the JAX package's shard_map bodies and
GSPMD insert.

`AxesGroup(mesh, axes)` names the ranks that share every coordinate but
those of `axes` (the data axes of a training mesh, a pipeline axis): its
`size`, this rank's `index` among them (the axes' coordinates as one
mixed-radix number, the first axis the most significant, which is the
order `sharding.local_shard` cuts blocks in) and the process group:
`mesh.group(axes)`, one axis's group, the world, or over ("pod", "data")
beside a model axis the subgroup of this rank's model coordinate, which
`launch.mesh.make_mesh` builds on every rank (`axes_groups`).

One route per (backend, tensor device), chosen from the mesh, never by
trying:

  * NCCL (one GPU a rank): the collective runs on the tensors where
    they are;
  * gloo with CUDA tensors (ranks sharing one card): every collective is
    STAGED THROUGH HOST MEMORY explicitly: the input is copied into a
    pinned host buffer, the collective runs there, and the result is
    copied back to the card. Gloo's own CUDA support differs by
    collective and by build, so ranks sharing a card take this one known
    route. The group keeps its two pinned buffers (input and output,
    grown to the largest call, never shrunk) for its life: fresh
    pageable memory for every call costs its page faults each time;
  * gloo with CPU tensors: in place on the host.

A group of one rank needs no process group: every collective is the
identity (a copy). The functions return new tensors and leave their
inputs alone; `GatherDim` and `AllToAll` are the differentiable forms
(their backward is the inverse collective). The tensor-parallel
(Megatron) pair, the explicit form of the partial sums GSPMD inserts for
the reference's row-parallel weights: `CopyToGroup` (identity forward,
all-reduce backward) at the input of a block whose weights a rank holds
only part of, so the input's grad sums every rank's part, and
`ReduceFromGroup` (all-reduce forward, identity backward) at the output
of a row-parallel product, so a rank's partial becomes the whole value;
`copy_to` and `reduce_from` apply them (the identity without a group).
Both sum in f32 and round once to the tensor's dtype: over 2 ranks the
f32 sum of two bf16 values is exact, the reference's bf16 psum
(moe.py:166). `RingShift` is `ring_shift` with the backward shift the
other way (the pipeline's ppermute). torch.distributed.nn.functional is
not used: its backward semantics are not these. Each group counts its
collectives and the bytes this rank put on the wire (`counts`: calls and
bytes by kind; chip_smoke.py's phase 18 reads a train step's from
`StepBundle.group`, phase 19 from `StepBundle.model_group`).

Over an abstract mesh (`launch.mesh.abstract_mesh`: no process, no
group) every collective is counted the same way and returns an empty
tensor of its result's shape (`new_empty`; a fake tensor under
FakeTensorMode), so analyze.census.census_step reads a rank's
collectives from the counts of a step it never ran.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.launch.mesh import ABSTRACT


class AxesGroup:
    """The ranks of `mesh` that differ only in their `axes` coordinates
    (axes the mesh lacks are left out, so a mesh without them gives a
    group of one), over `mesh.group(axes)`: one axis's group, the world
    where the axes cover every rank, else the subgroup the mesh built for
    them (the data axes ("pod", "data") beside a model axis). The axes
    must be in the mesh's order, so the group rank is `index`."""

    def __init__(self, mesh, axes: Sequence[str]):
        self.mesh = mesh
        self.axes = tuple(a for a in axes if mesh is not None
                          and a in mesh.shape)
        self.size, self.index = 1, 0
        for a in self.axes:
            n = int(mesh.shape[a])
            self.size *= n
            self.index = self.index * n + int(mesh.coords[a])
        self.backend = getattr(mesh, "backend", None)
        self.group = None
        self.counts = {"calls": {}, "bytes": {}}
        self._buffers = {}
        if self.size == 1:
            return
        import torch.distributed as dist
        self.group = mesh.group(self.axes)
        if self.abstract:
            return
        if dist.get_rank(self.group) != self.index:
            raise ValueError(f"axes {self.axes} must be in the mesh's order "
                             f"{tuple(mesh.shape)}: group rank "
                             f"{dist.get_rank(self.group)} != index "
                             f"{self.index}")

    @property
    def abstract(self) -> bool:
        """Over an abstract mesh: collectives counted, nothing sent."""
        return self.backend == ABSTRACT

    def __repr__(self) -> str:
        return (f"AxesGroup(axes={self.axes}, size={self.size}, "
                f"index={self.index}, backend={self.backend!r})")

    # -- staging ----------------------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host(self, slot: str, shape, dtype) -> torch.Tensor:
        """A pinned host tensor of `shape` and `dtype` in the reusable
        staging buffer `slot` ("in" or "out")."""
        n = math.prod(shape) * dtype.itemsize
        buf = self._buffers.get(slot)
        if buf is None or buf.numel() < n:
            self._buffers.pop(slot, None)
            buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            self._buffers[slot] = buf
        return buf[:n].view(dtype).view(shape)

    def _count(self, t: torch.Tensor, kind: str) -> None:
        """Count the collective `kind` on t: one call, t's bytes (what
        this rank hands the collective)."""
        calls, nbytes = self.counts["calls"], self.counts["bytes"]
        calls[kind] = calls.get(kind, 0) + 1
        nbytes[kind] = nbytes.get(kind, 0) + t.numel() * t.element_size()

    def _abstract(self, t: torch.Tensor, kind: str, shape) -> torch.Tensor:
        """An abstract mesh's collective: counted, an empty result of
        `shape` in t's dtype on t's device."""
        self._count(t, kind)
        return t.detach().new_empty(tuple(shape))

    def _wire(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """A contiguous copy of t where the collective `kind` runs on it
        (counted, `_count`)."""
        t = t.detach()
        self._count(t, kind)
        if self._staged(t):
            return self._host("in", tuple(t.shape), t.dtype).copy_(t)
        return t.contiguous().clone()

    def _out(self, t: torch.Tensor, x: torch.Tensor, shape) -> torch.Tensor:
        """Where a collective on t's wire copy x writes its result."""
        if self._staged(t):
            return self._host("out", tuple(shape), x.dtype)
        return x.new_empty(tuple(shape))

    # -- collectives --------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum (op="sum") or max (op="max") of t over the
        group; the same bits on every rank."""
        if self.size == 1:
            return t.detach().clone()
        if self.abstract:
            return self._abstract(t, "all_reduce", t.shape)
        import torch.distributed as dist
        x = self._wire(t, "all_reduce")
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=red, group=self.group)
        return x.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's t concatenated along `dim` in index order."""
        if self.size == 1:
            return t.detach().clone()
        if self.abstract:
            shape = list(t.shape)
            shape[dim] *= self.size
            return self._abstract(t, "all_gather", shape)
        import torch.distributed as dist
        x = self._wire(t.movedim(dim, 0), "all_gather")
        out = self._out(t, x, (self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out.to(t.device).movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block (index `index` of `size` along `dim`) of the
        sum of t over the group. With gloo it is an all_to_all (block j to
        rank j) and a local sum of the received blocks in rank order:
        gloo's own reduce_scatter moved half the bytes a second that its
        all_to_all did (tools/gloo_collective_probe.py on an H100)."""
        if t.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{self.size} ways")
        if self.size == 1:
            return t.detach().clone()
        if self.abstract:
            shape = list(t.shape)
            shape[dim] //= self.size
            return self._abstract(t, "reduce_scatter", shape)
        import torch.distributed as dist
        x = self._wire(t.movedim(dim, 0), "reduce_scatter")
        if self.backend == "gloo":
            parts = self._out(t, x, x.shape)
            dist.all_to_all_single(parts, x, group=self.group)
            blocks = (self.size, -1) + tuple(x.shape[1:])
            parts = parts.view(blocks)
            out = x.view(blocks)[0].copy_(parts[0])    # x is sent: reuse it
            for p in parts[1:]:
                out += p
        else:
            out = self._out(t, x, (x.shape[0] // self.size,)
                            + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=self.group)
        return out.to(t.device).movedim(0, dim)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t's dim 0 (size x ...) split in `size` parts, part j sent to rank
        j; the result's part i is what rank i sent here (lax.all_to_all
        with split and concat axis 0)."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} must "
                             f"be the group size {self.size}")
        if self.size == 1:
            return t.detach().clone()
        if self.abstract:
            return self._abstract(t, "all_to_all", t.shape)
        import torch.distributed as dist
        x = self._wire(t, "all_to_all")
        out = self._out(t, x, x.shape)
        dist.all_to_all_single(out, x, group=self.group)
        return out.to(t.device)

    def ring_shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """ppermute over the ring i -> i + step: t goes to that rank, and
        rank i - step's t comes back (same shape and dtype)."""
        if self.size == 1:
            return t.detach().clone()
        if self.abstract:
            return self._abstract(t, "ring_shift", t.shape)
        import torch.distributed as dist
        x = self._wire(t, "ring_shift")
        out = self._out(t, x, x.shape)
        nxt = dist.get_global_rank(self.group, (self.index + step) % self.size)
        prv = dist.get_global_rank(self.group, (self.index - step) % self.size)
        reqs = [dist.isend(x, nxt, group=self.group),
                dist.irecv(out, prv, group=self.group)]
        for r in reqs:
            r.wait()
        return out.to(t.device)

    def barrier(self) -> None:
        if self.size > 1 and not self.abstract:
            import torch.distributed as dist
            dist.barrier(group=self.group)


class GatherDim(torch.autograd.Function):
    """y = every rank's x concatenated along `dim` (all_gather); the
    backward sums the ranks' grads of y and keeps this rank's block
    (reduce_scatter), so each x receives the grad of every rank's use of
    it."""

    @staticmethod
    def forward(ctx, x, dim: int, group: AxesGroup):
        ctx.dim, ctx.group = dim, group
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class AllToAll(torch.autograd.Function):
    """group.all_to_all(x); its own inverse, so the backward sends each
    grad part back to the rank it came from."""

    @staticmethod
    def forward(ctx, x, group: AxesGroup):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


def _sum_f32(group: AxesGroup, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the group in f32, rounded once to t's dtype."""
    return group.all_reduce(t.float()).to(t.dtype)


class CopyToGroup(torch.autograd.Function):
    """y = x (x the same on every rank of the group); the backward sums the
    ranks' grads of y, so x receives the grad of every rank's part of the
    block that uses it (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group: AxesGroup):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(ctx.group, g), None


class ReduceFromGroup(torch.autograd.Function):
    """y = the sum of every rank's x (a row-parallel product's partials);
    the backward hands y's grad to each rank's x as it is (Megatron's g):
    y is the same on every rank, and each computes the same loss of it."""

    @staticmethod
    def forward(ctx, x, group: AxesGroup):
        return _sum_f32(group, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class RingShift(torch.autograd.Function):
    """group.ring_shift(x): x to the next rank; the backward sends the grad
    back to the rank x came from."""

    @staticmethod
    def forward(ctx, x, group: AxesGroup):
        ctx.group = group
        return group.ring_shift(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.ring_shift(g.contiguous(), step=-1), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """CopyToGroup over `group`; x itself where group is None or of one
    rank."""
    if group is None or group.size == 1:
        return x
    return CopyToGroup.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """ReduceFromGroup over `group`; x itself where group is None or of one
    rank."""
    if group is None or group.size == 1:
        return x
    return ReduceFromGroup.apply(x, group)
