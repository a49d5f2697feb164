"""Linear learners (logistic / squared loss) trained by SGD.

Counterpart of ``dmlc_core_tpu/models/linear.py``: the same parameters,
the same initial weights (numpy ``RandomState(seed)``, so both packages
start from the same bits), and the same dense and sparse SGD steps, on
the port's :class:`~dmlc_core_tpu_torch.bridge.batching.DenseBatch` and
:class:`~dmlc_core_tpu_torch.bridge.batching.SparseBatch`.  The model
lives on ``device`` (``cuda`` unless the caller passes ``device="cpu"``);
a batch is moved there by the step that takes it.

A step forms the weighted gradient sums, the weight sum and the loss sum,
and divides them by ``max(Σ w, 1)``.  Under an ambient mesh whose
``data`` axis spans more than one rank (``with make_mesh():`` in a launch
of several workers) each rank's batch is its slice of the global batch,
and the sums are all-reduced over the data group in one collective
first, so the denominator is the global one, as in the reference's step
over its global arrays: every rank holds the same params and the global
loss.  Without such a mesh the collective is the identity.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.bridge.batching import DenseBatch
from dmlc_core_tpu_torch.collective.mesh_collectives import data_allreduce
from dmlc_core_tpu_torch.ops.sparse import (segment_matvec,
                                            segment_transpose_matvec)
from dmlc_core_tpu_torch.param import Parameter, field
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["LinearParam", "LinearModel", "batch_to"]


class LinearParam(Parameter):
    num_feature = field(int, lower=1, help="feature dimension")
    learning_rate = field(float, default=0.1, lower=0.0, help="SGD step size")
    reg_lambda = field(float, default=0.0, lower=0.0, help="L2 regularization")
    loss = field(str, default="logistic", enum=["logistic", "squared"],
                 help="objective")


def batch_to(batch, device: torch.device):
    """``batch`` (a Dense or Sparse batch NamedTuple) with every tensor on
    ``device``."""
    return type(batch)(*[t.to(device) if isinstance(t, torch.Tensor) else t
                         for t in batch])


def _loss_grad(margin: torch.Tensor, label: torch.Tensor,
               loss: str) -> torch.Tensor:
    if loss == "logistic":
        p = 1.0 / (1.0 + torch.exp(-margin))
        return p - label
    return margin - label


def _loss_sum(margin: torch.Tensor, label: torch.Tensor,
              weight: torch.Tensor, loss: str) -> torch.Tensor:
    """The weighted loss summed over the rows (the numerator)."""
    if loss == "logistic":
        # numerically-stable weighted logloss
        ls = torch.logaddexp(torch.zeros_like(margin), margin) - label * margin
        return (ls * weight).sum()
    return (weight * (margin - label) ** 2).sum()


class LinearModel:
    """SGD linear model over dense or sparse batches."""

    def __init__(self, param: LinearParam, device=None):
        self.param = param
        self.device = resolve_device(device)

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        rng = np.random.RandomState(seed)
        w = rng.normal(0, 0.01, self.param.num_feature).astype(np.float32)
        return {"w": torch.from_numpy(w).to(self.device),
                "b": torch.zeros((), dtype=torch.float32, device=self.device)}

    def _margin(self, params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        if isinstance(batch, DenseBatch):
            return batch.x @ params["w"] + params["b"]
        return segment_matvec(params["w"], batch.value, batch.index,
                              batch.row_id, batch.label.shape[0]) \
            + params["b"]

    @torch.no_grad()
    def train_step(self, params: Dict[str, torch.Tensor], batch) \
            -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One SGD step; returns (new_params, loss)."""
        p = self.param
        lr, lam = p.learning_rate, p.reg_lambda
        batch = batch_to(batch, self.device)
        w, b = params["w"], params["b"]
        nf = p.num_feature
        margin = self._margin(params, batch)
        g = _loss_grad(margin, batch.label, p.loss) * batch.weight
        if isinstance(batch, DenseBatch):
            xtg = batch.x.T @ g
        else:
            # sentinel slot for padding rows
            g_ext = torch.cat([g, g.new_zeros(1)])
            xtg = segment_transpose_matvec(g_ext, batch.value, batch.index,
                                           batch.row_id, nf)
        # X^T g, Σ g, Σ w and the loss sum in one all-reduce
        sums, = data_allreduce(torch.cat([xtg, torch.stack([
            g.sum(), batch.weight.sum(),
            _loss_sum(margin, batch.label, batch.weight, p.loss)])]))
        denom = torch.clamp(sums[nf + 1], min=1.0)
        grad_w = sums[:nf] / denom + lam * w
        grad_b = sums[nf] / denom
        new = {"w": w - lr * grad_w, "b": b - lr * grad_b}
        return new, sums[nf + 2] / denom

    @torch.no_grad()
    def predict(self, params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        margin = self._margin(params, batch_to(batch, self.device))
        if self.param.loss == "logistic":
            return 1.0 / (1.0 + torch.exp(-margin))
        return margin

    def fit(self, loader, num_epochs: int = 1,
            params: Optional[Dict[str, Any]] = None, log_every: int = 0):
        """Train over a batch loader; returns (params, last_loss)."""
        from dmlc_core_tpu_torch.utils.logging import log_info

        params = params or self.init_params()
        loss = None
        step = 0
        for epoch in range(num_epochs):
            if epoch > 0:
                loader.before_first()
            for batch in loader:
                params, loss = self.train_step(params, batch)
                step += 1
                if log_every and step % log_every == 0:
                    log_info(f"step {step}: loss={float(loss):.5f}")
        return params, loss
