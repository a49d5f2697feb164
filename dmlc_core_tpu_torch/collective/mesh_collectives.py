"""Collectives over one axis of a :class:`..parallel.mesh.Mesh`.

Counterpart of ``dmlc_core_tpu/collective/mesh_collectives.py``.  The JAX
class takes a global array ``[axis_size, ...]`` whose slice ``i`` is shard
``i``'s contribution and runs the collective under ``shard_map``.  Here
every rank is a process, so the same contract is written in SPMD form:
each rank passes its own shard (the JAX slice ``i`` on the rank at axis
coordinate ``i``, without the leading axis) and receives its own shard of
the result.  Every rank of the axis line must make the same call.

Tensors may lie on the CPU or the card.  Under the ``gloo`` backend a CUDA
tensor is copied to host memory and back here, explicitly: gloo stages
CUDA tensors through the host in any case, and some builds lack CUDA
``all_gather`` under gloo.  That copy is the transport; the kernels that
made the tensor ran on the card.  Under ``nccl`` tensors stay on the card.

``axis`` may be a tuple of axes: the line over their product, in the
flattened coordinate order (the JAX ``psum(x, ("a", "b"))``).
:meth:`MeshCollective.ppermute` and :meth:`MeshCollective.all_to_all` are
the JAX ``lax.ppermute`` (a shift around the line) and ``lax.all_to_all``
(``tiled=True``); :func:`ppermute` and :func:`all_to_all` are their
differentiable forms, whose backward is the transpose JAX applies (the
inverse shift, the inverse all-to-all).  :func:`ring_allreduce` is the
reference's explicit ring (a reduce-scatter, then an all-gather, over
point-to-point sends), and :func:`allreduce_bandwidth_gbps` its algbw
meter.

The rows of a fit are split over the ambient mesh's row axes
(``Mesh.row_axes``: ``("data",)`` on a mesh with a ``data`` axis, or
what ``with data_sharding(mesh, axis=...)`` names), which
:func:`data_parallel` and :func:`data_allreduce` read.

Every :class:`MeshCollective` op records the span ``collective.<op>``,
named as :mod:`.api` names its own: ``collective.sum`` (``max``,
``min``) for :meth:`~MeshCollective.allreduce` and
:meth:`~MeshCollective.psum`, ``collective.gather``,
``collective.reduce_scatter``, ``collective.broadcast``,
``collective.ppermute`` and ``collective.all_to_all``, with the host
attributes ``payload_bytes`` (this rank's tensor), ``axis`` and ``ranks``
(the line's length), and counts ``dmlc_collective_ops_total`` and
``dmlc_collective_payload_bytes_total`` labelled ``op``.  A fit's
histogram all-reduce is a ``collective.sum`` inside its level's
``gbdt.hist`` span, its leaf-sum all-reduce one inside ``gbdt.leaf``
(:mod:`..models.gbdt`).  With telemetry off and no profiler recording
an op costs one branch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.parallel.mesh import Axes, ambient_mesh
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["MeshCollective", "data_parallel", "data_allreduce", "ppermute",
           "all_to_all", "ring_allreduce",
           "allreduce_bandwidth_gbps"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class MeshCollective:
    """Collectives over ``axis`` (an axis or a tuple of axes) of
    ``mesh``, on this rank's line."""

    def __init__(self, mesh, axis: Axes = "data"):
        self.mesh = mesh
        self.axis = axis
        self.axis_size = mesh.axis_size(axis)
        self.index = mesh.coord(axis)
        self._group = mesh.group(axis)
        CHECK(self._group is not None or self.axis_size == 1,
              f"axis {axis!r} spans {self.axis_size} ranks but this mesh "
              f"has no process group for it (build it with make_mesh "
              f"after collective.init, and a tuple's with make_groups)")
        # torch orders a group by ascending global rank, which along a
        # mesh line is the coordinate order
        self._ranks = mesh.line_ranks(axis)
        self._via_host = (self._group is not None
                          and dist.get_backend(self._group) == "gloo")
        self._axis_name = axis if isinstance(axis, str) else ",".join(axis)

    def _send(self, x: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``x`` where the backend takes it."""
        if self._via_host and x.is_cuda:
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone().contiguous()

    def _run(self, opname: str, fn, x: torch.Tensor, *args):
        """``fn(x, *args)`` inside the span ``collective.<opname>`` (host
        attributes ``payload_bytes``: this rank's ``x``, ``axis``,
        ``ranks``) with the ``dmlc_collective_ops_total`` and
        ``dmlc_collective_payload_bytes_total`` counters labelled
        ``op=opname``; with telemetry off and no profiler recording, one
        branch and the call.  No latency series: under ``nccl`` the op
        runs on the card after the call returns, so its time is read from
        a device trace."""
        if not telemetry.active():
            return fn(x, *args)
        nbytes = x.numel() * x.element_size()
        with telemetry.span(f"collective.{opname}", payload_bytes=nbytes,
                            axis=self._axis_name, ranks=self.axis_size):
            out = fn(x, *args)
        telemetry.count("dmlc_collective_ops_total", op=opname)
        telemetry.count("dmlc_collective_payload_bytes_total", nbytes,
                        op=opname)
        return out

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """This rank's shard of the reduction (every shard holds the same
        reduced value): ``op`` in {sum, max, min}."""
        CHECK(op in _OPS, f"unknown op {op!r}")
        return self._run(op, self._allreduce, x, op)

    def _allreduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        t = self._send(x)
        if self._group is not None:
            dist.all_reduce(t, op=_OPS[op], group=self._group)
        return t.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the shards along the axis."""
        return self.allreduce(x, "sum")

    def allgather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every shard concatenated along ``dim`` in axis-coordinate order
        (the JAX ``all_gather(tiled=True)`` on ``dim``)."""
        return self._run("gather", self._allgather, x, dim)

    def _allgather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        t = self._send(x)
        if self._group is None:
            return t.to(x.device)
        parts = [torch.empty_like(t) for _ in range(self.axis_size)]
        dist.all_gather(parts, t, group=self._group)
        return torch.cat(parts, dim=dim).to(x.device)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Slice ``index`` (this rank's axis coordinate) of the sum of the
        shards' ``[elems]`` partials; ``elems`` must divide by the axis
        size.  Reduces the whole vector, then keeps the slice."""
        CHECK(x.dim() >= 1 and x.shape[0] % self.axis_size == 0,
              f"reduce_scatter needs dim 0 divisible by {self.axis_size}, "
              f"got {tuple(x.shape)}")
        return self._run("reduce_scatter", self._reduce_scatter, x)

    def _reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        k = x.shape[0] // self.axis_size
        return self._allreduce(x, "sum")[self.index * k:
                                         (self.index + 1) * k].clone()

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """The shard of the rank at axis coordinate ``root``, on every
        rank."""
        CHECK(0 <= root < self.axis_size,
              f"root {root} out of range for axis size {self.axis_size}")
        return self._run("broadcast", self._broadcast, x, root)

    def _broadcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        t = self._send(x)
        if self._group is not None:
            dist.broadcast(t, src=self._ranks[root], group=self._group)
        return t.to(x.device)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The shard of the rank ``shift`` coordinates behind: this rank
        sends ``x`` to coordinate ``(index + shift) % n`` and receives from
        ``(index - shift) % n`` (the JAX ``ppermute`` with the permutation
        ``i -> i + shift``), in one batch of point-to-point ops."""
        return self._run("ppermute", self._ppermute, x, shift)

    def _ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        n = self.axis_size
        if self._group is None or shift % n == 0:
            return self._send(x).to(x.device)
        t = self._send(x)
        out = torch.empty_like(t)
        # p2p peers are global ranks, also inside a group
        ops = [dist.P2POp(dist.isend, t, self._ranks[(self.index + shift) % n],
                          self._group),
               dist.P2POp(dist.irecv, out,
                          self._ranks[(self.index - shift) % n], self._group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(x.device)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """The JAX ``all_to_all(x, axis, split_dim, concat_dim,
        tiled=True)``: ``x`` cut into ``n`` blocks along ``split_dim``,
        block ``j`` sent to coordinate ``j``, and the blocks received
        concatenated along ``concat_dim`` in coordinate order."""
        CHECK(x.shape[split_dim] % self.axis_size == 0,
              f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not "
              f"split into {self.axis_size} blocks")
        return self._run("all_to_all", self._all_to_all, x, split_dim,
                         concat_dim)

    def _all_to_all(self, x: torch.Tensor, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
        if self._group is None:
            return self._send(x).to(x.device)
        src = self._send(torch.stack(torch.chunk(x, self.axis_size,
                                                 dim=split_dim)))
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._group)
        return torch.cat(out.to(x.device).unbind(0), dim=concat_dim)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, shift):
        ctx.coll, ctx.shift = coll, shift
        return coll.ppermute(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.coll.ppermute(g.contiguous(), -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, coll, split_dim, concat_dim):
        ctx.coll, ctx.dims = coll, (split_dim, concat_dim)
        return coll.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (ctx.coll.all_to_all(g.contiguous(), concat_dim, split_dim),
                None, None, None)


def ppermute(x: torch.Tensor, coll: MeshCollective,
             shift: int = 1) -> torch.Tensor:
    """:meth:`MeshCollective.ppermute`, differentiable: the gradient goes
    back by the inverse shift.  Every rank of the line must run the
    backward too."""
    return _PPermute.apply(x, coll, shift)


def all_to_all(x: torch.Tensor, coll: MeshCollective, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """:meth:`MeshCollective.all_to_all`, differentiable: the gradient
    goes back by the all-to-all with the two dims swapped."""
    return _AllToAll.apply(x, coll, split_dim, concat_dim)


def ring_allreduce(mesh, axis: Axes, x: torch.Tensor) -> torch.Tensor:
    """The sum of the shards over ``axis`` by the reference's explicit
    ring: ``x`` (this rank's shard) cut into ``n`` segments on dim 0,
    ``n - 1`` reduce-scatter steps (at step ``k`` send segment ``(c - k)
    % n`` to the next rank and add the one received into segment ``(c - k
    - 1) % n``), then ``n - 1`` all-gather steps (send ``(c - k + 1) % n``,
    receive into ``(c - k) % n``).  The same segment order and additions
    as ``_build_ring_allreduce``."""
    coll = MeshCollective(mesh, axis)
    n, c = coll.axis_size, coll.index
    CHECK(x.shape[0] % n == 0,
          f"ring_allreduce: dim 0 of {tuple(x.shape)} does not split into "
          f"{n} segments")
    segs = list(x.reshape((n, -1) + tuple(x.shape[1:])).clone().unbind(0))
    for k in range(n - 1):
        got = coll.ppermute(segs[(c - k) % n], 1)
        segs[(c - k - 1) % n] = segs[(c - k - 1) % n] + got
    for k in range(n - 1):
        segs[(c - k) % n] = coll.ppermute(segs[(c - k + 1) % n], 1)
    return torch.stack(segs).reshape(x.shape)


def allreduce_bandwidth_gbps(mesh, axis: Axes, nbytes: int = 64 << 20,
                             iters: int = 10, dtype=np.float32,
                             device=None) -> float:
    """Effective all-reduce bandwidth over ``axis`` in GB/s, the
    reference's algbw: ``2 (n - 1) / n * bytes / seconds``, where
    ``bytes`` is the whole array of ``n`` shards of ``nbytes / n`` bytes
    and each iteration is one ``psum`` of this rank's shard (on
    ``device``, ``cuda`` unless the caller passes ``device="cpu"``),
    timed by :func:`..utils.profiler.device_timer` (the card synchronised
    before the clock stops)."""
    from dmlc_core_tpu_torch.utils.device import resolve_device
    from dmlc_core_tpu_torch.utils.profiler import device_timer

    coll = MeshCollective(mesh, axis)
    n = coll.axis_size
    itemsize = np.dtype(dtype).itemsize
    elems = max(1, nbytes // itemsize // max(n, 1))
    x = torch.ones(elems, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                   device=resolve_device(device))
    _, seconds = device_timer(coll.psum, x, iters=iters, warmup=1)
    payload = elems * itemsize * n
    algbw = 2 * (n - 1) / max(n, 1) * payload / max(seconds, 1e-12)
    return algbw / 1e9


def data_parallel() -> bool:
    """Whether the ambient mesh's row axes span more than one rank."""
    mesh = ambient_mesh()
    return (mesh is not None and bool(mesh.row_axes)
            and mesh.axis_size(mesh.row_axes) > 1)


def data_allreduce(*tensors):
    """The tensors (of one shape) summed over the ambient mesh's row-axes
    group (``data`` on a flat mesh) when it spans more than one rank, as
    one collective (the reference gets these sums from GSPMD); else the
    tensors unchanged."""
    if not data_parallel():
        return tensors
    mesh = ambient_mesh()
    return tuple(MeshCollective(mesh, mesh.row_axes).psum(
        torch.stack(tensors)))
