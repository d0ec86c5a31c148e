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

Hardware constants are the H100's (H100 80GB HBM3, 700 W): the peak bf16
rate and the HBM rate are ``launch/bench_kernels.py``'s data-sheet figures.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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

    def _run(self, op, t: torch.Tensor, axes) -> torch.Tensor:
        """``op(t, group size, group name)``, waited on. Gloo is a host
        transport: a CUDA tensor goes through host memory there, and only
        there."""
        group = self.group(axes)
        staged = self.backend == "gloo" and t.is_cuda
        src = t.cpu() if staged else t
        out = _c10d().wait_tensor(op(src.contiguous(), dist.get_world_size(group),
                                     group.group_name))
        return out.to(t.device) if staged else out

    def _all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        n = int(np.prod([self.shape[a] for a in axes]))
        out = self._run(_c10d().all_gather_into_tensor, t, axes)      # (n * t.shape[0], ...)
        return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)

    def _all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        return self._run(lambda x, n, name: _c10d().all_reduce(x, "sum", name), t, axes)

    def _reduce_scatter(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        n = int(np.prod([self.shape[a] for a in axes]))
        if dim:
            t = torch.cat(t.chunk(n, dim=dim))
        return self._run(lambda x, size, name: _c10d().reduce_scatter_tensor(x, "sum", size, name),
                         t, axes)

    def all_gather(self, t: torch.Tensor, dim: int, axes: Sequence[str]) -> torch.Tensor:
        """The blocks of ``t`` of every rank along ``axes``, concatenated on
        ``dim`` in row-major order of the axes (a tiled all-gather)."""
        axes = self._live(axes)
        return _AllGather.apply(t, dim, self, axes) if axes else t

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axes`` (a psum)."""
        axes = self._live(axes)
        return _AllReduce.apply(t, self, axes) if axes else t


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small mesh over the ranks that exist (unit tests)."""
    return Mesh((data, model), ("data", "model"))


def n_chips(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
