"""A named mesh over the ranks of a ``torch.distributed`` job.

Counterpart of ``dmlc_core_tpu/parallel/mesh.py``.  In JAX a mesh factors
the devices of one SPMD program into named axes (``{"data": 4, "model":
2}``).  Here every rank is a process, so a :class:`Mesh` factors the
ranks of the world, row-major in axis order: the rank at coordinate
``(d, m)`` of a ``{"data": D, "model": M}`` mesh is ``d * M + m``.  Each
rank holds one ``torch.distributed`` group per axis: the line of ranks
that share all its other coordinates.  Collectives over an axis
(:class:`..collective.mesh_collectives.MeshCollective`) run in that group.

``with mesh:`` makes the mesh ambient, as ``with mesh:`` does in JAX, so
``grad_histogram`` and ``GBDT`` read it without new arguments.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["Mesh", "make_mesh", "ambient_mesh", "local_shard_info",
           "row_range"]

_ambient = threading.local()


class Mesh:
    """This rank's view of a mesh: the axis sizes, its coordinates, and the
    process group of each axis line it belongs to.

    A mesh built directly, without groups, is a layout only: collectives
    over an axis longer than one rank raise on it.  :func:`make_mesh`
    builds the groups."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[str, Any]] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        CHECK(all(s >= 1 for s in self.shape.values()),
              f"mesh axes must be positive, got {self.shape}")
        CHECK(0 <= rank < self.size,
              f"rank {rank} outside a mesh of {self.size} ranks")
        self.rank = rank
        self._groups = dict(groups or {})

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def _strides(self) -> Dict[str, int]:
        strides, s = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = s
            s *= self.shape[name]
        return strides

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        CHECK(axis in self.shape, f"axis {axis!r} not in mesh "
                                  f"{self.axis_names}")
        return (self.rank // self._strides()[axis]) % self.shape[axis]

    def line_ranks(self, axis: str) -> List[int]:
        """Global ranks of this rank's line along ``axis``, in coordinate
        order (also ascending rank order)."""
        stride = self._strides()[axis]
        base = self.rank - self.coord(axis) * stride
        return [base + i * stride for i in range(self.shape[axis])]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None on a
        layout-only mesh or a single-process job."""
        CHECK(axis in self.shape, f"axis {axis!r} not in mesh "
                                  f"{self.axis_names}")
        return self._groups.get(axis)

    def __enter__(self) -> "Mesh":
        if not hasattr(_ambient, "stack"):
            _ambient.stack = []
        _ambient.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ambient.stack.pop()


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost enclosing ``with mesh:`` block on this
    thread, or None."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


def _mesh_shape(axes: Optional[Dict[str, int]], nranks: int
                ) -> Tuple[Tuple[str, ...], List[int]]:
    """Axis names and sizes with the one ``-1`` inferred; the reference's
    checks and messages (a rank here is a device there)."""
    if not axes:
        axes = {"data": nranks}
    names = tuple(axes.keys())
    sizes = list(axes.values())
    n_infer = sum(1 for s in sizes if s == -1)
    CHECK(n_infer <= 1, "at most one mesh axis may be -1")
    if n_infer:
        known = int(np.prod([s for s in sizes if s != -1]))
        CHECK(nranks % known == 0,
              f"{nranks} devices not divisible by {known}")
        sizes = [nranks // known if s == -1 else s for s in sizes]
    CHECK(int(np.prod(sizes)) == nranks,
          f"mesh axes {dict(zip(names, sizes))} do not cover {nranks} "
          f"devices")
    return names, sizes


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over every rank of the job, e.g. ``{"data": 2, "model": 2}``.

    One axis may be -1 (inferred); the default is one ``data`` axis over
    all ranks.  In a job with a process group every rank must call this,
    in the same order as its other group-making calls: it makes one group
    per line of every axis, on every rank, including the lines the rank is
    not in (``new_group`` is collective).  In a single-process job the
    mesh has one rank and no groups."""
    from dmlc_core_tpu_torch.collective.api import group_timeout

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    names, sizes = _mesh_shape(axes, world)
    mesh = Mesh(dict(zip(names, sizes)), rank)
    if not dist.is_initialized():
        return mesh
    layout = np.arange(world).reshape(sizes)
    for i, name in enumerate(names):
        # each row of the moved-axis layout is one line along `name`, in
        # the same row-major order on every rank
        lines = np.moveaxis(layout, i, -1).reshape(-1, sizes[i])
        for line in lines:
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks, timeout=group_timeout())
            if rank in ranks:
                mesh._groups[name] = group
    return mesh


def local_shard_info() -> Tuple[int, int]:
    """(part_index, num_parts) for this process: the input shard it reads
    when every rank reads its own part."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def row_range(mesh: Mesh, num_rows: int, axis: str = "data"
              ) -> Tuple[int, int]:
    """``[lo, hi)`` of this rank's rows of a ``num_rows`` dataset, split
    evenly over ``axis`` by the rank's coordinate there, so that ranks that
    differ only along other axes (the model shards of one data shard)
    read the same rows."""
    parts = mesh.shape.get(axis, 1)
    d = mesh.coord(axis) if axis in mesh.shape else 0
    return d * num_rows // parts, (d + 1) * num_rows // parts
