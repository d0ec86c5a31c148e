"""Meshes over ``torch.distributed``: the port of ``repro/launch/mesh.py``.

Built by FUNCTIONS (never module-level meshes), over whatever process group
exists: gloo ranks in the tests, the fake 256/512-rank group of the dry-run
(``launch/dryrun.py``), NCCL on a multi-GPU machine. A mesh of one device
needs no process group. :class:`Mesh` carries the reference's
``axis_names`` and ``shape`` dict, this rank's index on each axis, the
process group of any set of axes, and the collectives the expert-parallel
MoE runs (``models/moe.py``). The collectives are the
``_c10d_functional`` ops, so a ``make_fx`` trace records them, and they
are differentiable with the reference's transposes (an all-gather's
gradient is a reduce-scatter, an all-reduce's an all-reduce).

:meth:`Mesh.shard_in` and :meth:`Mesh.shard_out` are a region's boundary,
the in_specs and out_specs of the reference's ``shard_map``. Their
gradients are that ``shard_map``'s transpose with its replication check
off (``check_vma=False``, as ``repro/models/moe.py`` runs it): an output's
cotangent is this rank's block divided by the ranks that hold the same
block, and an input's cotangent is summed over the axes its spec leaves
out. With the inner transposes above, every rank's gradient is then its
share of the global function's, whichever axes the values inside vary
over.

Hardware constants are the H100's (H100 80GB HBM3, 700 W): the peak bf16
rate and the HBM rate are ``launch/bench_kernels.py``'s data-sheet figures.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.sharding import PartitionSpec, shard_tensor
from repro_torch.launch.bench_kernels import BF16_FLOPS as PEAK_FLOPS_BF16   # noqa: F401
from repro_torch.launch.bench_kernels import HBM_BYTES_PER_S as HBM_BW       # noqa: F401

# H100 80GB HBM3, 700 W: torch.cuda.get_device_properties(0).total_memory,
# read on the card by chip_smoke.py's dryrun phase
HBM_BYTES = 85_017_493_504
# H100 SXM NVLink 4: 900 GB/s per GPU in both directions together, so 450
# GB/s each way (NVIDIA data sheet; nothing on one card measures it)
NVLINK_BW = 450e9


def _c10d():
    return torch.ops._c10d_functional


class Mesh:
    """A named mesh of ``shape`` over the ranks of the default process group
    (rank r sits at ``np.unravel_index(r, shape)``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        size = int(np.prod(list(self.shape.values())))
        self.device_mesh = None
        self.backend = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if not dist.is_initialized():
            if size != 1:
                raise RuntimeError(f"a mesh of {size} devices needs a process group of "
                                   f"{size} ranks (torch.distributed.init_process_group)")
            self._coords = {a: 0 for a in self.axis_names}
            return
        if dist.get_world_size() != size:
            raise RuntimeError(f"mesh {tuple(shape)} needs {size} ranks, the process "
                               f"group has {dist.get_world_size()}")
        from torch.distributed.device_mesh import DeviceMesh
        self.backend = dist.get_backend()
        ranks = np.arange(size).reshape(tuple(self.shape.values()))
        self.device_mesh = DeviceMesh("cuda" if self.backend == "nccl" else "cpu",
                                      torch.as_tensor(ranks), mesh_dim_names=self.axis_names)
        coords = np.unravel_index(dist.get_rank(), ranks.shape)
        self._coords = {a: int(c) for a, c in zip(self.axis_names, coords)}
        # one group per set of axes, made by every rank in the same order
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                dims = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(ranks.ndim) if i not in dims]
                blocks = np.moveaxis(ranks, dims + rest, list(range(ranks.ndim)))
                lists = blocks.reshape(int(np.prod([ranks.shape[i] for i in dims])), -1).T
                group, _ = dist.new_subgroups_by_enumeration(
                    [[int(r) for r in row] for row in lists])
                self._groups[axes] = group

    def axis_index(self, axis: str) -> int:
        return self._coords[axis]

    def _live(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` in mesh order, those of size 1 left out."""
        return tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)

    def group(self, axes: Sequence[str]):
        return self._groups[tuple(a for a in self.axis_names if a in axes)]

    # -- the collectives (over the live axes; none at all is the identity) --

    def _run(self, kind: str, t: torch.Tensor, axes) -> torch.Tensor:
        """The collective ``kind`` ("all_gather" along dim 0, "all_reduce" or
        "reduce_scatter" along dim 0, each a sum) of ``t`` over the group of
        ``axes``, waited on. Gloo is a host transport: a CUDA tensor goes
        through host memory there, and only there."""
        group = self.group(axes)
        n, name = dist.get_world_size(group), group.group_name
        staged = self.backend == "gloo" and t.is_cuda
        src = (t.cpu() if staged else t).contiguous()
        if kind == "all_gather":
            out = _c10d().all_gather_into_tensor(src, n, name)
        elif kind == "all_reduce":
            out = _c10d().all_reduce(src, "sum", name)
        else:
            out = _c10d().reduce_scatter_tensor(src, "sum", n, name)
        out = _c10d().wait_tensor(out)
        return out.to(t.device) if staged else out

    def _size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def _all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        out = self._run("all_gather", t, axes)                        # (n * t.shape[0], ...)
        return out if dim == 0 else torch.cat(out.chunk(self._size(axes)), dim=dim)

    def _all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        return self._run("all_reduce", t, axes)

    def _reduce_scatter(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        if dim:
            t = torch.cat(t.chunk(self._size(axes), dim=dim))
        return self._run("reduce_scatter", t, axes)

    def all_gather(self, t: torch.Tensor, dim: int, axes: Sequence[str]) -> torch.Tensor:
        """The blocks of ``t`` of every rank along ``axes``, concatenated on
        ``dim`` in row-major order of the axes (a tiled all-gather)."""
        axes = self._live(axes)
        return _AllGather.apply(t, dim, self, axes) if axes else t

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes`` (a psum)."""
        axes = self._live(axes)
        return _AllReduce.apply(t, self, axes) if axes else t

    def shard_in(self, t: torch.Tensor, spec: PartitionSpec, whole: bool) -> torch.Tensor:
        """This rank's block of the global ``t`` by ``spec`` (an in_spec).
        The gradient is summed over the live axes ``spec`` leaves out; then,
        if ``whole`` (``t`` is replicated outside the region, as the tokens
        are), gathered over the axes it names, so every rank holds the whole
        gradient; else (a sharded weight) put in ``t``'s shape, zero outside
        this rank's block."""
        return _ShardIn.apply(t, spec, self, whole)

    def shard_out(self, t: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        """The global tensor whose block by ``spec`` each rank holds in ``t``
        (an out_spec), every rank's block the same along the axes ``spec``
        leaves out."""
        return _ShardOut.apply(t, spec, self)

    def _spec_axes(self, spec: PartitionSpec):
        """Per dim of ``spec``, the live axes it is split over; and the live
        axes it names nowhere."""
        named = [self._live(e if isinstance(e, tuple) else (e,)) if e is not None else ()
                 for e in spec]
        rest = tuple(a for a in self._live(self.axis_names) if not any(a in n for n in named))
        return named, rest


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return mesh._all_gather(t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._reduce_scatter(g, ctx.dim, ctx.axes), None, None, None


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_reduce(g, ctx.axes), None, None


class _ShardIn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, spec, mesh, whole):
        ctx.spec, ctx.mesh, ctx.whole, ctx.shape = spec, mesh, whole, t.shape
        return shard_tensor(t, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        named, rest = mesh._spec_axes(ctx.spec)
        if rest:
            g = mesh._all_reduce(g, rest)
        if ctx.whole:
            for dim, axes in enumerate(named):
                if axes:
                    g = mesh._all_gather(g, dim, axes)
        else:
            full = g.new_zeros(ctx.shape)
            shard_tensor(full, ctx.spec, mesh).copy_(g)
            g = full
        return g, None, None, None


class _ShardOut(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        named, _ = mesh._spec_axes(spec)
        for dim, axes in enumerate(named):
            if axes:
                t = mesh._all_gather(t, dim, axes)
        return t

    @staticmethod
    def backward(ctx, g):
        _, rest = ctx.mesh._spec_axes(ctx.spec)
        g = shard_tensor(g, ctx.spec, ctx.mesh)
        return (g / ctx.mesh._size(rest) if rest else g), None, None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small mesh over the ranks that exist (unit tests)."""
    return Mesh((data, model), ("data", "model"))


def n_chips(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
