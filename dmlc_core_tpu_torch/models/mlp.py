"""MLP classifier/regressor: the generic NN path of the port.

Counterpart of ``dmlc_core_tpu/models/mlp.py``: the same parameters and
initial weights (numpy ``RandomState(seed)``), ``bf16`` matmuls, the same
losses, and an Adam step written out by hand so that it follows
``optax.adam``'s order of operations (``torch.optim.Adam`` orders them
otherwise).  ``jax.nn.gelu`` defaults to the tanh approximation, so the
port's gelu is ``F.gelu(x, approximate="tanh")``.  The model lives on
``device`` (``cuda`` unless the caller passes ``device="cpu"``).

Under an ambient mesh whose ``data`` axis spans more than one rank, a
step is data-parallel: each rank takes the autograd gradients of its
batch slice's loss *sum*, and those, the loss sum and the weight sum go
out in one all-reduce over the data group; dividing by the global
``max(Σ w, 1)`` gives the gradient of the reference's global-batch loss,
and every rank applies the same Adam update.  Without such a mesh the step
is the single-process one.

``MLP(model_axis="model")`` shards the columns of the middle layers
(``0 < i < len(layers) - 1``, as the reference's sharding constraint
does) over the ``model`` axis of the mesh (``mesh=``, else the ambient
one): each rank of a model line holds its column block of those layers'
``w`` and ``b`` and of their Adam moments.  The forward is Megatron's: a
sharded layer's input is replicated on the line, the rank multiplies it
by its block, and the blocks are gathered (:class:`_GatherColumns`,
whose backward keeps the rank's slice of the replicated gradient).  The
layer's backward (:class:`_ColumnLinear`) sums the partial input
gradients of the line in float32 and rounds once, as the unsharded GEMM
does (in bf16 each partial rounded before the sum would drift from it).
The data-parallel all-reduce above runs unchanged over the data line.
At the boundaries the tree has the reference's full shapes:
:meth:`MLP.init_params` draws the full weights and keeps the rank's
block (:meth:`MLP.shard_params`), and :meth:`MLP.gather_params` builds
the full tree (checkpoints, :mod:`..convert`).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dmlc_core_tpu_torch.bridge.batching import DenseBatch
from dmlc_core_tpu_torch.collective.mesh_collectives import (MeshCollective,
                                                         data_allreduce,
                                                         data_parallel)
from dmlc_core_tpu_torch.models.linear import batch_to
from dmlc_core_tpu_torch.param import Parameter, field
from dmlc_core_tpu_torch.parallel.mesh import ambient_mesh
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["MLPParam", "MLP", "AdamState"]

# optax.adam's defaults
_B1 = 0.9
_B2 = 0.999
_EPS = 1e-8


class MLPParam(Parameter):
    num_feature = field(int, lower=1, help="input dimension")
    hidden = field(str, default="128,128",
                   help="comma-separated hidden layer widths")
    num_class = field(int, default=2, lower=1,
                      help="output classes (1 = regression)")
    learning_rate = field(float, default=1e-3, lower=0.0, help="adam lr")
    activation = field(str, default="relu", enum=["relu", "tanh", "gelu"],
                       help="nonlinearity")
    bf16 = field(bool, default=True, help="bfloat16 matmuls")

    def hidden_sizes(self) -> List[int]:
        return [int(w) for w in self.hidden.split(",") if w.strip()]


class AdamState(NamedTuple):
    """``optax.scale_by_adam``'s state: the step count and both moments,
    each a tree shaped like the params."""
    count: torch.Tensor
    mu: Dict[str, Any]
    nu: Dict[str, Any]


def _tanh_gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")


_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh, "gelu": _tanh_gelu}


def _leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    return [t for layer in params["layers"] for t in (layer["w"], layer["b"])]


def _rebuild(leaves: List[torch.Tensor]) -> Dict[str, Any]:
    return {"layers": [{"w": leaves[i], "b": leaves[i + 1]}
                       for i in range(0, len(leaves), 2)]}


class _ColumnLinear(torch.autograd.Function):
    """``h @ w + b`` on the rank's column block of a sharded layer, ``h``
    replicated on the model line.  Backward: ``dh`` is the sum over the
    line of the partial ``dy @ w.T``, taken in float32 and rounded once
    to ``h``'s dtype; ``dw`` and ``db`` are the block's own, as autograd
    computes them for the unsharded layer."""

    @staticmethod
    def forward(ctx, h, w, b, coll):
        ctx.save_for_backward(h, w)
        ctx.coll = coll
        return h @ w + b

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        partial = dy.to(torch.float32) @ w.to(torch.float32).t()
        dh = ctx.coll.psum(partial).to(h.dtype)
        return dh, h.t() @ dy, dy.sum(0), None


class _GatherColumns(torch.autograd.Function):
    """The line's column blocks side by side (the forward all-gather);
    the gradient downstream is replicated, so the backward keeps the
    rank's slice of it, with no sum."""

    @staticmethod
    def forward(ctx, y, coll):
        ctx.coll, ctx.width = coll, y.shape[1]
        # float32 on the wire: exact for bf16, whatever the backend takes
        return coll.allgather(y.to(torch.float32), dim=1).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.coll.index * ctx.width
        return g[:, lo:lo + ctx.width].contiguous(), None


class MLP:
    """Plain-torch MLP with a hand-written Adam state."""

    def __init__(self, param: MLPParam, model_axis: Optional[str] = None,
                 device=None, mesh=None):
        self.param = param
        self.model_axis = model_axis
        self.device = resolve_device(device)
        self._mesh = mesh

    def _model_mesh(self):
        """The mesh of the model axis; None without ``model_axis``."""
        if self.model_axis is None:
            return None
        mesh = self._mesh if self._mesh is not None else ambient_mesh()
        CHECK(mesh is not None and self.model_axis in mesh.shape,
              f"MLP(model_axis={self.model_axis!r}) needs a mesh with that "
              f"axis: pass mesh= or run under `with mesh:`")
        return mesh

    def _model_line(self) -> Optional[MeshCollective]:
        """The model line's collectives; None without ``model_axis``."""
        mesh = self._model_mesh()
        return None if mesh is None else MeshCollective(mesh,
                                                        self.model_axis)

    def _sharded(self, i: int, num_layers: int) -> bool:
        return self.model_axis is not None and 0 < i < num_layers - 1

    def shard_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The rank's tree from a full one (the reference's shapes): the
        rank's column block of each middle layer's ``w`` and ``b``."""
        mesh = self._model_mesh()
        layers = params["layers"]
        out = []
        for i, layer in enumerate(layers):
            if mesh is None or not self._sharded(i, len(layers)):
                out.append(dict(layer))
                continue
            width, parts = layer["w"].shape[1], mesh.shape[self.model_axis]
            CHECK(width % parts == 0,
                  f"layer {i}'s {width} columns do not split over {parts} "
                  f"model ranks")
            k = width // parts
            lo = mesh.coord(self.model_axis) * k
            out.append({"w": layer["w"][:, lo:lo + k].contiguous(),
                        "b": layer["b"][lo:lo + k].contiguous()})
        return {"layers": out}

    def gather_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The full tree (the reference's shapes) from the rank's: the
        model line's blocks gathered, on every rank of the line.  Any tree
        shaped like the params (the Adam moments) gathers the same way."""
        coll = self._model_line()
        layers = params["layers"]
        out = []
        for i, layer in enumerate(layers):
            if coll is None or not self._sharded(i, len(layers)):
                out.append(dict(layer))
                continue
            out.append({"w": coll.allgather(layer["w"], dim=1),
                        "b": coll.allgather(layer["b"], dim=0)})
        return {"layers": out}

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """The reference's ``RandomState(seed)`` weights, drawn whole; with
        ``model_axis`` the rank keeps its blocks."""
        rng = np.random.RandomState(seed)
        layers = []
        sizes = [self.param.num_feature] + self.param.hidden_sizes()
        out_dim = 1 if self.param.num_class == 1 else self.param.num_class
        dims = list(zip(sizes, sizes[1:])) + [(sizes[-1], out_dim)]
        for fan_in, fan_out in dims:
            scale = np.sqrt(2.0 / fan_in)
            w = rng.normal(0, scale, (fan_in, fan_out)).astype(np.float32)
            layers.append({
                "w": torch.from_numpy(w).to(self.device),
                "b": torch.zeros((fan_out,), dtype=torch.float32,
                                 device=self.device),
            })
        params = {"layers": layers}
        return params if self.model_axis is None \
            else self.shard_params(params)

    def _apply(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        act = _ACTIVATIONS[self.param.activation]
        compute_dtype = torch.bfloat16 if self.param.bf16 else torch.float32
        coll = self._model_line()
        h = x.to(compute_dtype)
        layers = params["layers"]
        for i, layer in enumerate(layers):
            w = layer["w"].to(compute_dtype)
            b = layer["b"].to(compute_dtype)
            if coll is not None and self._sharded(i, len(layers)):
                h = _GatherColumns.apply(
                    _ColumnLinear.apply(h, w, b, coll), coll)
            else:
                h = h @ w + b
            if i < len(layers) - 1:
                h = act(h)
        return h.to(torch.float32)

    def _loss_sum(self, params: Dict[str, Any], batch: DenseBatch
                  ) -> torch.Tensor:
        """The weighted loss summed over the batch's rows."""
        logits = self._apply(params, batch.x)
        w = batch.weight
        if self.param.num_class == 1:
            err = (logits[:, 0] - batch.label) ** 2
            return (err * w).sum()
        labels = batch.label.to(torch.int64)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
        return (nll * w).sum()

    def _loss(self, params: Dict[str, Any], batch: DenseBatch) -> torch.Tensor:
        denom = torch.clamp(batch.weight.sum(), min=1.0)
        return self._loss_sum(params, batch) / denom

    def init_optimizer(self, params: Dict[str, Any]) -> AdamState:
        zeros = _rebuild([torch.zeros_like(t) for t in _leaves(params)])
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=self.device),
            mu=zeros,
            nu=_rebuild([torch.zeros_like(t) for t in _leaves(params)]))

    def train_step(self, params: Dict[str, Any], opt_state: AdamState,
                   batch: DenseBatch) \
            -> Tuple[Dict[str, Any], AdamState, torch.Tensor]:
        """One Adam step (``optax.adam(learning_rate)``); returns
        ``(params, opt_state, loss)``."""
        batch = batch_to(batch, self.device)
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        if data_parallel():
            loss, grads = self._data_parallel_grads(leaves, batch)
        else:
            with torch.enable_grad():
                loss = self._loss(_rebuild(leaves), batch)
                grads = torch.autograd.grad(loss, leaves)
        lr = self.param.learning_rate
        with torch.no_grad():
            count = opt_state.count + 1
            # optax's bias correction: 1 - decay**count in float32
            bc1 = 1 - torch.tensor(_B1, dtype=torch.float32,
                                   device=self.device) ** count
            bc2 = 1 - torch.tensor(_B2, dtype=torch.float32,
                                   device=self.device) ** count
            new_p, new_mu, new_nu = [], [], []
            for p, g, m, v in zip(leaves, grads, _leaves(opt_state.mu),
                                  _leaves(opt_state.nu)):
                m = (1 - _B1) * g + _B1 * m
                v = (1 - _B2) * g ** 2 + _B2 * v
                update = (m / bc1) / (torch.sqrt(v / bc2) + _EPS)
                new_p.append(p.detach() + (-lr) * update)
                new_mu.append(m)
                new_nu.append(v)
        return (_rebuild(new_p),
                AdamState(count=count, mu=_rebuild(new_mu),
                          nu=_rebuild(new_nu)),
                loss.detach())

    def _data_parallel_grads(self, leaves: List[torch.Tensor],
                             batch: DenseBatch):
        """(global loss, gradients of it) over the data group: the local
        loss sum's gradients, the loss sum and the weight sum in one
        all-reduce, divided by the global ``max(Σ w, 1)``."""
        with torch.enable_grad():
            num = self._loss_sum(_rebuild(leaves), batch)
            grads = torch.autograd.grad(num, leaves)
        local = torch.cat([g.reshape(-1) for g in grads]
                          + [torch.stack([num.detach(),
                                          batch.weight.sum()])])
        sums, = data_allreduce(local)
        denom = torch.clamp(sums[-1], min=1.0)
        out, at = [], 0
        for g in grads:
            out.append(sums[at:at + g.numel()].reshape(g.shape) / denom)
            at += g.numel()
        return sums[-2] / denom, out

    @torch.no_grad()
    def predict(self, params: Dict[str, Any], x) -> torch.Tensor:
        """Probabilities (or the regression output) of the rows ``x``
        from the rank's tree, on every rank (with ``model_axis`` the
        columns are gathered as in a step)."""
        # non_blocking: a copy from pageable memory is staged before the
        # call returns, and does not wait for the work queued before it
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device,
                                                       non_blocking=True)
        logits = self._apply(params, x)
        if self.param.num_class == 1:
            return logits[:, 0]
        return torch.softmax(logits, dim=-1)
