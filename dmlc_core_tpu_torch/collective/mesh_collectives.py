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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["MeshCollective"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class MeshCollective:
    """Collectives over ``axis`` of ``mesh``, on this rank's line."""

    def __init__(self, mesh, axis: str = "data"):
        CHECK(axis in mesh.axis_names,
              f"axis {axis!r} not in mesh {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self.axis_size = mesh.shape[axis]
        self.index = mesh.coord(axis)
        self._group = mesh.group(axis)
        CHECK(self._group is not None or self.axis_size == 1,
              f"axis {axis!r} spans {self.axis_size} ranks but this mesh "
              f"has no process group for it (build it with make_mesh "
              f"after collective.init)")
        # torch orders a group by ascending global rank, which along a
        # mesh line is the coordinate order
        self._ranks = mesh.line_ranks(axis)
        self._via_host = (self._group is not None
                          and dist.get_backend(self._group) == "gloo")

    def _send(self, x: torch.Tensor) -> torch.Tensor:
        """A private contiguous copy of ``x`` where the backend takes it."""
        if self._via_host and x.is_cuda:
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone().contiguous()

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """This rank's shard of the reduction (every shard holds the same
        reduced value): ``op`` in {sum, max, min}."""
        CHECK(op in _OPS, f"unknown op {op!r}")
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
        k = x.shape[0] // self.axis_size
        return self.psum(x)[self.index * k:(self.index + 1) * k].clone()

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """The shard of the rank at axis coordinate ``root``, on every
        rank."""
        CHECK(0 <= root < self.axis_size,
              f"root {root} out of range for axis size {self.axis_size}")
        t = self._send(x)
        if self._group is not None:
            dist.broadcast(t, src=self._ranks[root], group=self._group)
        return t.to(x.device)
