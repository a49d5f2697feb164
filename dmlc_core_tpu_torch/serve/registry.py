"""Model registry: named slots, per-slot budgets, zero-downtime swaps.

Counterpart of ``dmlc_core_tpu/serve/registry.py`` (a copy).  The
multi-model half of the model lifecycle: a :class:`ModelRegistry` owns one :class:`ModelSlot`
per served model name, and each slot owns **everything that model's
traffic touches** —

- the live :class:`~.model_runtime.ModelRuntime` (behind the slot's
  :class:`~.scheduler.MicroBatcher`, which snapshots it once per batch);
- the slot **version** (the checkpoint step it was built from);
- its own :class:`~.admission.AdmissionController` with a per-model
  queue-bytes budget, so one model's burst sheds that model's traffic and
  never a co-hosted neighbour's;
- the bucket-ladder warmup contract (every slot's shapes run once before
  its batcher starts).

:meth:`ModelRegistry.swap` is the zero-downtime flip the checkpoint
watcher (:mod:`.lifecycle`) drives: the new runtime is fully built,
validated, and pre-warmed *off-path* before the registry is ever asked,
and the swap itself is a single pointer flip under the batcher's own lock
(:meth:`~.scheduler.MicroBatcher.set_runtime`) — in-flight batches finish
on the old runtime, queued requests ride onto the new one, and nothing is
dropped, crashed, or scored by a half-swapped model.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.serve.admission import (AdmissionController,
                                                 queue_bytes_from_env)
from dmlc_core_tpu_torch.serve.errors import UnknownModel
from dmlc_core_tpu_torch.serve.model_runtime import ModelRuntime
from dmlc_core_tpu_torch.serve.scheduler import MicroBatcher
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.logging import CHECK, log_info

__all__ = ["ModelRegistry", "ModelSlot"]


class ModelSlot:
    """One served model name: runtime + version + batcher + budget."""

    def __init__(self, name: str, runtime: ModelRuntime, *,
                 version: int = 0, max_batch: int = 64,
                 max_delay_ms: float = 2.0,
                 max_queue_bytes: Optional[int] = None):
        self.name = name
        self.num_feature = runtime.num_feature
        self.version = version
        runtime.version = version
        self.admission = AdmissionController(
            max_queue_bytes if max_queue_bytes is not None
            else queue_bytes_from_env(), name=name)
        self.batcher = MicroBatcher(runtime, max_batch=max_batch,
                                    max_delay_ms=max_delay_ms,
                                    admission=self.admission, name=name)
        self.warmed = False
        self.swapped_at: Optional[float] = None

    @property
    def runtime(self) -> ModelRuntime:
        """The live runtime (reads the batcher's pointer — always whole:
        the flip is atomic and dispatch snapshots per batch)."""
        return self.batcher.runtime

    @property
    def family(self) -> str:
        return self.runtime.name

    def describe(self) -> Dict[str, object]:
        """The /healthz (and /stats) identity block for this slot."""
        return {"family": self.family, "version": self.version,
                "num_feature": self.num_feature,
                "max_batch": self.batcher.max_batch,
                "max_queue_bytes": self.admission.max_queue_bytes}


class ModelRegistry:
    """Named model slots behind one routing surface.

    Add every slot before :meth:`start`; the lifecycle watcher then only
    ever *swaps* runtimes inside existing slots — slot topology is a
    deploy-time decision, model versions are a runtime one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: Dict[str, ModelSlot] = {}
        self._default: Optional[str] = None

    # -- topology -------------------------------------------------------------

    def add(self, name: str, runtime: ModelRuntime, *, version: int = 0,
            max_batch: int = 64, max_delay_ms: float = 2.0,
            max_queue_bytes: Optional[int] = None,
            default: bool = False) -> ModelSlot:
        CHECK(bool(name) and "/" not in name,
              f"model name {name!r} must be non-empty and slash-free "
              "(it rides in the /v1/score/<model> path)")
        slot = ModelSlot(name, runtime, version=version,
                         max_batch=max_batch, max_delay_ms=max_delay_ms,
                         max_queue_bytes=max_queue_bytes)
        with self._lock:
            CHECK(name not in self._slots,
                  f"model slot {name!r} already registered")
            self._slots[name] = slot
            if default or self._default is None:
                self._default = name
        telemetry.gauge_set("dmlc_serve_swap_version", float(version),
                            model=name)
        return slot

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    @property
    def default_name(self) -> Optional[str]:
        return self._default

    def get(self, name: Optional[str] = None) -> ModelSlot:
        """Resolve a route: ``None`` means the default slot.  Raises the
        structured 404 (:class:`~.errors.UnknownModel`) for the transport
        to map straight onto the wire."""
        with self._lock:
            key = name if name is not None else self._default
            slot = self._slots.get(key) if key is not None else None
        if slot is None:
            raise UnknownModel(
                f"no model {name!r} is registered"
                if name is not None else "no models registered",
                details={"models": self.names()})
        return slot

    # -- lifecycle ------------------------------------------------------------

    def start(self, warmup: bool = True) -> None:
        """Warm every slot's bucket ladder, then start its batcher —
        steady-state requests never pay a first call's set-up."""
        for slot in self._all():
            if warmup and not slot.warmed:
                slot.runtime.warmup(slot.batcher.buckets)
                slot.warmed = True
            slot.batcher.start()

    def swap(self, name: str, runtime: ModelRuntime, version: int) -> None:
        """The zero-downtime flip: install a fully-built, pre-warmed
        runtime into ``name``'s slot.  Raises ``ValueError`` (feature
        contract) or :class:`~.errors.UnknownModel` without touching the
        live slot — the caller (the watcher) turns both into
        "previous-good keeps serving"."""
        slot = self.get(name)
        old_version = slot.version
        # the flip and the stamps happen under the registry lock: the
        # watcher thread swaps while the main thread reads describe()/
        # get(), and a torn version/warmed/swapped_at trio would report
        # a half-swapped slot
        with self._lock:
            # stamp BEFORE the flip: no batch can snapshot the new
            # runtime without its version riding along
            runtime.version = version
            slot.batcher.set_runtime(runtime)  # the atomic pointer flip
            slot.version = version
            slot.warmed = True
            slot.swapped_at = clock.monotonic()
        telemetry.gauge_set("dmlc_serve_swap_version", float(version),
                            model=name)
        log_info(f"serve: model {name!r} swapped "
                 f"v{old_version} -> v{version} ({runtime.name})")

    def close(self) -> None:
        for slot in self._all():
            slot.batcher.close()

    def _all(self) -> List[ModelSlot]:
        # snapshot under the lock, operate outside it: batcher start/close
        # block (thread join) and must not run under the registry lock
        with self._lock:
            return list(self._slots.values())

    def describe(self) -> Dict[str, Dict[str, object]]:
        return {slot.name: slot.describe() for slot in self._all()}
