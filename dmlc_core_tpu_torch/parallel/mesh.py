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

A tuple of axes names the line over their product, as ``psum(x, ("a",
"b"))`` does in JAX (axes in mesh order); its groups are made by
:func:`make_groups`, which :func:`data_sharding` calls for a tuple.  The
axes that rows are split over (the *row axes*) are ``("data",)`` on a
mesh with a ``data`` axis and none otherwise; :func:`data_sharding`
names others (the hybrid mesh's ``("dcn_data", "ici_data")``), and
``with`` that sharding makes the mesh ambient with those row axes, which
is where the reference's GSPMD finds them in the sharding of its inputs.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["Mesh", "Sharding", "make_mesh", "make_groups",
           "make_hybrid_mesh", "data_sharding", "replicated_sharding",
           "ambient_mesh", "local_shard_info", "row_range"]

_ambient = threading.local()

Axes = Union[str, Sequence[str]]


def _group_key(names: Tuple[str, ...]):
    """Where a mesh keeps the group of a line: by the axis name, or by the
    tuple of names."""
    return names[0] if len(names) == 1 else names


class Mesh:
    """This rank's view of a mesh: the axis sizes, its coordinates, and the
    process group of each axis line it belongs to.

    A mesh built directly, without groups, is a layout only: collectives
    over an axis longer than one rank raise on it.  :func:`make_mesh`
    builds the groups."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict[Any, Any]] = None,
                 row_axes: Optional[Sequence[str]] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        CHECK(all(s >= 1 for s in self.shape.values()),
              f"mesh axes must be positive, got {self.shape}")
        CHECK(0 <= rank < self.size,
              f"rank {rank} outside a mesh of {self.size} ranks")
        self.rank = rank
        self._groups = dict(groups or {})
        if row_axes is None:
            row_axes = ("data",) if "data" in self.shape else ()
        # the axes rows are split over (none: every rank holds every row)
        self.row_axes = self.axes(row_axes) if row_axes else ()

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def _strides(self) -> Dict[str, int]:
        strides, s = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = s
            s *= self.shape[name]
        return strides

    def axes(self, axis: Axes) -> Tuple[str, ...]:
        """``axis`` as a tuple of axis names, checked to be axes of this
        mesh, distinct and in mesh order."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        CHECK(len(names) >= 1, "an empty tuple names no mesh axis")
        for name in names:
            CHECK(name in self.shape, f"axis {name!r} not in mesh "
                                      f"{self.axis_names}")
        order = [self.axis_names.index(n) for n in names]
        CHECK(order == sorted(set(order)),
              f"axes {names} must be distinct and in mesh order "
              f"{self.axis_names}")
        return names

    def axis_size(self, axis: Axes) -> int:
        """The number of ranks on a line along ``axis`` (the product of
        the sizes of a tuple's axes)."""
        return int(np.prod([self.shape[a] for a in self.axes(axis)],
                           dtype=np.int64))

    def coord(self, axis: Axes) -> int:
        """This rank's coordinate along ``axis``; along a tuple, the
        row-major flattening of its coordinates on those axes."""
        c = 0
        for name in self.axes(axis):
            c = c * self.shape[name] + \
                (self.rank // self._strides()[name]) % self.shape[name]
        return c

    def line_ranks(self, axis: Axes) -> List[int]:
        """Global ranks of this rank's line along ``axis``, in coordinate
        order (also ascending rank order)."""
        names = self.axes(axis)
        strides = self._strides()
        base = self.rank - sum(
            ((self.rank // strides[n]) % self.shape[n]) * strides[n]
            for n in names)
        return [base + sum(i * strides[n] for i, n in zip(idx, names))
                for idx in itertools.product(*(range(self.shape[n])
                                               for n in names))]

    def group(self, axis: Axes):
        """The process group of this rank's line along ``axis``; None on a
        layout-only mesh, in a single-process job, or for a tuple of axes
        whose groups :func:`make_groups` has not made."""
        return self._groups.get(_group_key(self.axes(axis)))

    def with_rows(self, row_axes: Axes) -> "Mesh":
        """This mesh, its groups shared, with ``row_axes`` (an axis, a
        tuple of axes, or ``()`` for none) as the axes rows are split
        over."""
        return Mesh(self.shape, self.rank, self._groups,
                    self.axes(row_axes) if row_axes else ())

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


def _new_groups(mesh: Mesh, names: Tuple[str, ...]) -> None:
    """One group per line along the axes ``names``, made on every rank
    (``new_group`` is collective); this rank keeps its own."""
    from dmlc_core_tpu_torch.collective.api import group_timeout

    sizes = [mesh.shape[n] for n in mesh.axis_names]
    idx = [mesh.axis_names.index(n) for n in names]
    width = int(np.prod([sizes[i] for i in idx]))
    # each row of the moved-axes layout is one line along `names`, in the
    # same row-major order on every rank
    lines = np.moveaxis(np.arange(mesh.size).reshape(sizes), idx,
                        list(range(-len(idx), 0))).reshape(-1, width)
    for line in lines:
        ranks = [int(r) for r in line]
        group = dist.new_group(ranks, timeout=group_timeout())
        if mesh.rank in ranks:
            mesh._groups[_group_key(names)] = group


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over every rank of the job, e.g. ``{"data": 2, "model": 2}``.

    One axis may be -1 (inferred); the default is one ``data`` axis over
    all ranks.  In a job with a process group every rank must call this,
    in the same order as its other group-making calls: it makes one group
    per line of every axis, on every rank, including the lines the rank is
    not in (``new_group`` is collective).  In a single-process job the
    mesh has one rank and no groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    names, sizes = _mesh_shape(axes, world)
    mesh = Mesh(dict(zip(names, sizes)), rank)
    if dist.is_initialized():
        for name in names:
            _new_groups(mesh, (name,))
    return mesh


def make_groups(mesh: Mesh, axis: Axes) -> None:
    """Give ``mesh`` the groups of the lines along ``axis``, a tuple of
    axes (one axis has its groups from :func:`make_mesh`).  Collective
    the first time: every rank of the job makes the call at the same
    point.  A no-op where the mesh has them, and on a mesh without groups
    (a single-process job, a layout-only ``Mesh``)."""
    names = mesh.axes(axis)
    if mesh._groups and _group_key(names) not in mesh._groups:
        _new_groups(mesh, names)


def make_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int]
                     ) -> Mesh:
    """The multi-slice mesh, e.g. ``make_hybrid_mesh({"ici_data": 2,
    "model": 2}, {"dcn_data": 2})``: the ``dcn_axes`` outermost, then the
    ``ici_axes``, ranks row-major.  This is the reference's layout off
    sliced hardware (its reshape of the device list, dcn axes outermost),
    with rank *i* in the place of device *i*; every rank of the job must
    be in it."""
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = dict(dcn_axes, **ici_axes)
    CHECK(len(shape) == len(names),
          f"an axis is both dcn and ici: {names}")
    ndev = int(np.prod(list(shape.values())))
    world = dist.get_world_size() if dist.is_initialized() else 1
    CHECK(world == ndev, f"hybrid mesh {shape} needs {ndev} devices, the "
                         f"job has {world}")
    return make_mesh({n: shape[n] for n in names})


class Sharding:
    """Where a global array's rows live on ``mesh``: dim 0 split over
    ``axes`` (none: replicated), the rest replicated.  The counterpart of
    ``NamedSharding(mesh, P(axes, None, ...))``; ranks are processes, so
    :meth:`shard` hands this rank its block.  ``with sharding:`` makes
    the mesh ambient with ``axes`` as its row axes."""

    def __init__(self, mesh: Mesh, axes: Tuple[str, ...],
                 ndim: Optional[int]):
        self.mesh = mesh
        self.axes = axes
        self.ndim = ndim
        self._views: List[Mesh] = []

    @property
    def num_parts(self) -> int:
        return self.mesh.axis_size(self.axes) if self.axes else 1

    def block(self, num_rows: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's rows of a ``num_rows`` global
        array: the block at its flattened coordinate over ``axes``."""
        parts = self.num_parts
        CHECK(num_rows % parts == 0,
              f"{num_rows} rows do not split evenly over {self.axes} "
              f"({parts} parts)")
        k = num_rows // parts
        i = self.mesh.coord(self.axes) if self.axes else 0
        return i * k, (i + 1) * k

    def shard(self, x):
        """This rank's contiguous dim-0 block of the global array ``x``
        (``x`` itself when replicated)."""
        if not self.axes:
            return x
        # as for a PartitionSpec, the array may have more dims than named
        CHECK(len(x.shape) >= self.ndim,
              f"sharding of rank {self.ndim} given an array of shape "
              f"{tuple(x.shape)}")
        lo, hi = self.block(x.shape[0])
        return x[lo:hi]

    def __enter__(self) -> Mesh:
        view = self.mesh.with_rows(self.axes)
        self._views.append(view)
        return view.__enter__()

    def __exit__(self, *exc) -> None:
        self._views.pop().__exit__(*exc)


def data_sharding(mesh: Mesh, axis: Axes = "data", ndim: int = 1
                  ) -> Sharding:
    """Dim 0 on ``axis`` (an axis or a tuple of axes), rest replicated.
    A tuple's groups are made here (:func:`make_groups`), so every rank
    makes the call."""
    axes = mesh.axes(axis)
    make_groups(mesh, axes)
    return Sharding(mesh, axes, ndim)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """Every rank holds the whole array."""
    return Sharding(mesh, (), None)


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
