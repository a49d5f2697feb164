"""Model runtimes: the predict surface the scoring path serves.

Counterpart of ``dmlc_core_tpu/serve/model_runtime.py``.  A
:class:`ModelRuntime` owns everything the scoring path needs from a model:
the predict function, the feature-dimension contract, and **warmup**, which
runs predict once at every batch-bucket shape before the listener opens.
The port compiles nothing at run time, but warmup still matters: CUDA
context creation, the first allocations of each shape and the lazy kernel
build all land there instead of on the first requests.  The scheduler
(:mod:`.scheduler`) only ever sees ``predict(x[B, F]) -> y[B] | y[B, K]``
with ``B`` drawn from the bucket ladder it warmed up.

:class:`GBDTRuntime` serves a trained
:class:`~dmlc_core_tpu_torch.models.gbdt.TreeEnsemble` on the model's
device (``cuda`` unless ``device="cpu"``); :class:`LinearRuntime` and
:class:`MLPRuntime` serve the params of
:class:`~dmlc_core_tpu_torch.models.linear.LinearModel` (margin or
sigmoid) and :class:`~dmlc_core_tpu_torch.models.mlp.MLP` (softmax
probabilities or the regression head) there.

**The sync point.**  ``predict_async`` returns a :class:`PendingResult`:
the scores' copy to a pinned host tensor is queued behind the predict on
the device, with an event recorded after it.  :func:`to_host` waits on that
event only, so the scheduler can queue batch N+1 before it waits for
batch N without waiting for N+1 as well.

:func:`build_runtime` builds a runtime from a checkpoint (a GBDT
``serving_state``, or linear or MLP params), or from seeded synthetic
params for the CLI and tests.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.telemetry import tracecontext
from dmlc_core_tpu_torch.utils.logging import CHECK, log_info

__all__ = ["ModelRuntime", "LinearRuntime", "MLPRuntime", "GBDTRuntime",
           "PendingResult", "to_host", "build_runtime"]


class PendingResult:
    """A dispatched predict's scores on their way to the host.

    On ``cuda`` the copy into a fresh pinned host tensor is queued on the
    current stream behind the predict, and an event is recorded after it;
    :meth:`result` waits on that event alone.  On the CPU the scores are
    already on the host."""

    __slots__ = ("host", "event")

    def __init__(self, y: torch.Tensor):
        if y.device.type == "cuda":
            self.host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            self.host.copy_(y, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = y
            self.event = None

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def to_host(handle: Any) -> np.ndarray:
    """The device-to-host step of a predict handle: waits for the scores
    and returns them as a host ndarray (a failure on the device raises
    here)."""
    if isinstance(handle, PendingResult):
        return handle.result()
    if isinstance(handle, torch.Tensor):
        return handle.detach().cpu().numpy()
    return np.asarray(handle)


class ModelRuntime:
    """Base: a named predict function with a fixed feature contract."""

    #: model-family tag carried into metrics labels and /healthz
    name: str = "base"

    def __init__(self, num_feature: int):
        CHECK(num_feature >= 1, "num_feature must be >= 1")
        self.num_feature = int(num_feature)
        #: checkpoint step this runtime was built from; stamped by the
        #: model registry before the runtime can serve (None = unmanaged)
        self.version: Optional[int] = None

    def predict(self, x: np.ndarray) -> np.ndarray:
        """``[B, F] float32 -> [B]`` scores or ``[B, K]`` probabilities.

        ``B`` is a padded bucket size; padding rows produce garbage scores
        the scheduler slices off — runtimes must tolerate all-zero rows.
        Returns a **host** ndarray.  Subclasses override exactly one of
        ``predict`` (host-only runtimes) or ``predict_async`` (device
        runtimes).
        """
        if type(self).predict_async is ModelRuntime.predict_async:
            raise NotImplementedError(
                "runtimes must override predict or predict_async")
        return to_host(self.predict_async(x))

    def predict_async(self, x: np.ndarray):
        """Dispatch predict without waiting for the result; returns a
        handle :func:`to_host` resolves.  The scheduler's double-buffered
        loop dispatches batch N+1 (host binning, transfer, compute, all
        queued) before it resolves batch N.  The base implementation is
        the synchronous fallback for runtimes that override ``predict``.
        """
        return self.predict(x)

    def warmup(self, batch_sizes: Sequence[int]) -> int:
        """Run predict once at each batch bucket; returns shapes warmed.

        CUDA context creation, first allocations and the lazy kernel build
        happen here, before the listener opens, not on request N.
        """
        warmed = 0
        # all warmup calls share one trace (a fresh root unless the
        # process is already inside one), so "model load" reads as a
        # single story in the assembled timeline
        ctx = (tracecontext.new_root()
               if telemetry.enabled() and tracecontext.current() is None
               else None)
        with tracecontext.activate(ctx), \
                telemetry.span("serve.warmup_all", model=self.name):
            for b in sorted(set(int(b) for b in batch_sizes)):
                with telemetry.span("serve.warmup", model=self.name,
                                    batch=b):
                    self.predict(np.zeros((b, self.num_feature),
                                          np.float32))
                telemetry.count("dmlc_serve_warmup_total", model=self.name)
                warmed += 1
        log_info(f"serve: warmed {warmed} batch shape(s) for {self.name} "
                 f"({sorted(set(int(b) for b in batch_sizes))})")
        return warmed


class LinearRuntime(ModelRuntime):
    """Serving facade over LinearModel params (w, b): ``LinearModel.predict``
    of the rows (the sigmoid of the margin for ``logistic``, the margin
    itself for ``squared``)."""

    name = "linear"

    def __init__(self, model, params: Dict[str, torch.Tensor]):
        super().__init__(model.param.num_feature)
        self.model = model
        self.params = params

    @torch.no_grad()
    def predict_async(self, x: np.ndarray) -> PendingResult:
        from dmlc_core_tpu_torch.bridge.batching import DenseBatch

        # the copy is from pageable memory, which CUDA stages before the
        # call returns, so the host array may go at once
        rows = torch.as_tensor(x, dtype=torch.float32).to(self.model.device,
                                                          non_blocking=True)
        return PendingResult(self.model.predict(
            self.params, DenseBatch(rows, None, None)))


class MLPRuntime(ModelRuntime):
    """Serving facade over MLP params: ``MLP.predict`` of the rows
    (softmax probs / regression head)."""

    name = "mlp"

    def __init__(self, model, params: Dict[str, Any]):
        super().__init__(model.param.num_feature)
        self.model = model
        self.params = params

    def predict_async(self, x: np.ndarray) -> PendingResult:
        return PendingResult(self.model.predict(self.params, x))


class GBDTRuntime(ModelRuntime):
    """Serving facade over a trained TreeEnsemble + binning boundaries.

    Scoring goes through the **binned wire**: features are quantized on
    the host by a :class:`~dmlc_core_tpu_torch.bridge.binning.HostBinner`
    built from the model's own ``boundaries`` (the numpy
    ``searchsorted(side="right")`` twin of the device-side
    :func:`~dmlc_core_tpu_torch.ops.histogram.apply_bins`), and the uint8
    ids travel to the device.  Serving therefore applies the exact binning
    the model trained on: scores are bitwise equal to
    :meth:`predict_float`, the device-side float path.
    """

    name = "gbdt"

    def __init__(self, gbdt, ensemble):
        from dmlc_core_tpu_torch.bridge.binning import HostBinner

        CHECK(gbdt.boundaries is not None,
              "GBDTRuntime needs fitted binning boundaries (make_bins)")
        super().__init__(gbdt.num_feature)
        self.gbdt = gbdt
        self.ensemble = ensemble
        # the slot's binner edges: the train/serve-skew-free contract
        self.binner = HostBinner(np.asarray(gbdt.boundaries),
                                 gbdt.param.num_bins,
                                 handle_missing=gbdt.param.handle_missing)

    def predict_async(self, x: np.ndarray) -> PendingResult:
        # host binning -> narrow wire -> queued device work.  The copy is
        # from pageable memory, which CUDA stages before the call
        # returns, so the host array may go at once; the scores' copy back
        # is queued behind the predict (PendingResult)
        bins = torch.from_numpy(self.binner.transform(x)).to(
            self.gbdt.device, non_blocking=True)
        return PendingResult(self.gbdt.predict(self.ensemble, bins))

    def predict_float(self, x: np.ndarray) -> np.ndarray:
        """The training-time float path (device-side ``apply_bins``), kept
        as the reference the skew-free contract is checked against."""
        bins = self.gbdt.bin_features(x)
        return to_host(self.gbdt.predict(self.ensemble, bins))


def _load_params(checkpoint: str, template: Any,
                 device: torch.device) -> Any:
    """The params of a checkpoint, in ``template``'s structure, as tensors
    on ``device``."""
    from dmlc_core_tpu_torch.bridge.checkpoint import (load_checkpoint,
                                                       tree_map)

    return tree_map(lambda a: torch.tensor(a).to(device),
                    load_checkpoint(checkpoint, template=template))


def build_runtime(kind: str, num_feature: int, *, seed: int = 0,
                  num_class: int = 2, hidden: str = "32,32",
                  checkpoint: Optional[str] = None,
                  device=None) -> ModelRuntime:
    """Construct a runtime for serving on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``): the model of a checkpoint URI when
    given, else seeded synthetic params.

    ``linear`` and ``mlp`` start from ``init_params(seed)`` (for load and
    latency purposes the same as a trained model) and restore a
    checkpoint into that architecture.  ``gbdt`` without a checkpoint
    fits a small seeded ensemble on 256 synthetic rows at build time, as
    the reference does (there is no meaningful "random ensemble").
    """
    if kind == "linear":
        from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam

        param = LinearParam(num_feature=num_feature)
        model = LinearModel(param, device=device)
        params = model.init_params(seed)
        if checkpoint:
            params = _load_params(checkpoint, params, model.device)
        return LinearRuntime(model, params)
    if kind == "mlp":
        from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam

        model = MLP(MLPParam(num_feature=num_feature, hidden=hidden,
                             num_class=num_class), device=device)
        params = model.init_params(seed)
        if checkpoint:
            params = _load_params(checkpoint, params, model.device)
        return MLPRuntime(model, params)
    if kind == "gbdt":
        from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

        if checkpoint:
            from dmlc_core_tpu_torch.bridge.checkpoint import load_checkpoint

            # serving_state blobs are self-describing (trees + binner
            # edges + serve_meta in one tree): no template needed
            gbdt, ensemble = GBDT.from_serving_state(
                load_checkpoint(checkpoint), device=device)
            CHECK(gbdt.num_feature == num_feature,
                  f"checkpoint {checkpoint!r} serves {gbdt.num_feature} "
                  f"features but the slot contract is {num_feature}")
            return GBDTRuntime(gbdt, ensemble)
        rng = np.random.RandomState(seed)
        x = rng.normal(size=(256, num_feature)).astype(np.float32)
        label = (x[:, 0] + 0.5 * x[:, min(1, num_feature - 1)]
                 > 0).astype(np.float32)
        gbdt = GBDT(GBDTParam(objective="logistic", num_boost_round=8,
                              max_depth=3, num_bins=16), num_feature,
                    device=device)
        gbdt.make_bins(x)
        ensemble, _ = gbdt.fit_binned(gbdt.bin_features(x), label)
        return GBDTRuntime(gbdt, ensemble)
    raise ValueError(f"unknown model kind {kind!r} "
                     "(one of: linear, mlp, gbdt)")
