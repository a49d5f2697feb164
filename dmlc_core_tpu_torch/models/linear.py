"""Linear learners (logistic / squared loss) trained by SGD.

Counterpart of ``dmlc_core_tpu/models/linear.py``: the same parameters,
the same initial weights (numpy ``RandomState(seed)``, so both packages
start from the same bits), and the same dense and sparse SGD steps, on
the port's :class:`~dmlc_core_tpu_torch.bridge.batching.DenseBatch` and
:class:`~dmlc_core_tpu_torch.bridge.batching.SparseBatch`.  The model
lives on ``device`` (``cuda`` unless the caller passes ``device="cpu"``);
a batch is moved there by the step that takes it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.bridge.batching import DenseBatch
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


def _loss_value(margin: torch.Tensor, label: torch.Tensor,
                weight: torch.Tensor, loss: str) -> torch.Tensor:
    denom = torch.clamp(weight.sum(), min=1.0)
    if loss == "logistic":
        # numerically-stable weighted logloss
        ls = torch.logaddexp(torch.zeros_like(margin), margin) - label * margin
        return (ls * weight).sum() / denom
    return (weight * (margin - label) ** 2).sum() / denom


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
        margin = self._margin(params, batch)
        g = _loss_grad(margin, batch.label, p.loss) * batch.weight
        denom = torch.clamp(batch.weight.sum(), min=1.0)
        if isinstance(batch, DenseBatch):
            grad_w = batch.x.T @ g / denom + lam * w
        else:
            # sentinel slot for padding rows
            g_ext = torch.cat([g, g.new_zeros(1)])
            grad_w = segment_transpose_matvec(
                g_ext, batch.value, batch.index, batch.row_id,
                p.num_feature) / denom + lam * w
        grad_b = g.sum() / denom
        new = {"w": w - lr * grad_w, "b": b - lr * grad_b}
        return new, _loss_value(margin, batch.label, batch.weight, p.loss)

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
