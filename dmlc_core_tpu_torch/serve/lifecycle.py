"""Checkpoint watcher: the train→serve loop, closed with zero downtime.

Counterpart of ``dmlc_core_tpu/serve/lifecycle.py`` (a copy over the
port's :class:`~dmlc_core_tpu_torch.bridge.checkpoint.CheckpointManager`).
A continuously trained model lands as numbered checkpoints
(:class:`~dmlc_core_tpu_torch.bridge.checkpoint.CheckpointManager` layout:
``ckpt-XXXXXXXX`` + its ``.manifest.json``) on any URI-dispatched store —
local disk or any other store the port's ``io`` layer resolves.
:class:`CheckpointWatcher` polls
that directory and walks every new step through a four-stage state
machine, each stage a ``model.*`` span and a ``serve.swap`` fault-site
hit, before the live slot is ever touched:

``watch``
    list steps, pick the newest one above the slot's current version, and
    read its **manifest first** — a step without a manifest is still
    being written (the manager publishes the manifest only after the blob
    is durable), so a partially written checkpoint on a non-atomic remote
    store is *never even opened*.
``validate``
    re-hash the blob against the manifest (magic / byte count / CRC-32 —
    :func:`~dmlc_core_tpu_torch.bridge.checkpoint.verify_checkpoint`, no
    model work), then build the candidate runtime **off-path** via the slot's
    builder and check the structural contract (feature width).
``warmup``
    run the *entire* bucket ladder once on the shadow runtime (its
    tensors reach the device, its first allocations are made) — after the
    swap, no request shape pays a first call.
``swap``
    :meth:`~.registry.ModelRegistry.swap` — the atomic pointer flip under
    the batcher's lock.  In-flight batches finish on the old runtime;
    everything after runs whole on the new one.

A failure at any stage (corrupt bytes, a builder error, an injected
fault) leaves **previous-good serving**: the candidate is counted
(``dmlc_serve_swap_total{outcome="failed"}`` +
``dmlc_serve_swap_failures_total{stage=...}``), remembered so a bad step
is not re-validated every poll, and retried only when the store shows a
newer step (or the same step's bytes change).

Knobs: ``DMLC_SERVE_WATCH_S`` (poll interval, default 2.0 s).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                   verify_checkpoint)
from dmlc_core_tpu_torch.serve.model_runtime import (ModelRuntime,
                                                     build_runtime)
from dmlc_core_tpu_torch.serve.registry import ModelRegistry
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.logging import CHECK, log_info, log_warning

__all__ = ["CheckpointWatcher", "runtime_builder", "watch_interval_from_env"]

DEFAULT_WATCH_S = 2.0

# histogram bounds for whole-cycle swap latency (validate + warmup + flip;
# warmup runs the bucket ladder, so seconds-scale buckets)
_SWAP_SECONDS_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def watch_interval_from_env() -> float:
    raw = os.environ.get("DMLC_SERVE_WATCH_S", "").strip()
    if not raw:
        return DEFAULT_WATCH_S
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"DMLC_SERVE_WATCH_S must be a number of seconds, "
                         f"got {raw!r}") from None
    if v <= 0:
        raise ValueError(f"DMLC_SERVE_WATCH_S must be > 0, got {v}")
    return v


def runtime_builder(kind: str, num_feature: int,
                    **kwargs: Any) -> Callable[[str], ModelRuntime]:
    """The standard builder a watcher validates candidates with:
    ``build_runtime(kind, num_feature, checkpoint=<step uri>, ...)``.
    GBDT checkpoints are self-describing (``GBDT.serving_state``);
    ``device`` and ``seed`` pass through in ``kwargs``."""
    def build(checkpoint_uri: str) -> ModelRuntime:
        return build_runtime(kind, num_feature, checkpoint=checkpoint_uri,
                             **kwargs)
    return build


class CheckpointWatcher:
    """Poll a checkpoint directory; validate off-path; swap atomically.

    ``builder`` maps a checkpoint URI to a ready (unwarmed)
    :class:`~.model_runtime.ModelRuntime` — usually
    :func:`runtime_builder`.  One watcher serves one slot; multi-model
    deployments run one watcher per watched slot.
    """

    def __init__(self, registry: ModelRegistry, model: str,
                 directory: str, builder: Callable[[str], ModelRuntime],
                 *, poll_s: Optional[float] = None,
                 manager: Optional[CheckpointManager] = None):
        self.registry = registry
        self.model = model
        self.builder = builder
        self.manager = manager or CheckpointManager(directory)
        self.poll_s = poll_s if poll_s is not None \
            else watch_interval_from_env()
        CHECK(self.poll_s > 0, "poll_s must be > 0")
        # guards the progress odometers and the known-bad set: poll_once
        # is public API (tests/operators drive it inline) and also runs
        # on the watcher thread, so these are written from both sides
        self._lock = threading.Lock()
        self.swaps_completed = 0
        #: candidates rejected (validation/warmup/swap failures) — with
        #: ``swaps_completed``, the watcher's public progress odometer
        self.rejections = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (step, crc32) of every rejected candidate: bad bytes are never
        # re-validated on later polls (no hot loop), and the candidate
        # scan falls back PAST them to the next-newest published step —
        # bounded by retention's cap on how many steps the store keeps
        self._rejected: set = set()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "CheckpointWatcher":
        CHECK(self._thread is None or not self._thread.is_alive(),
              "watcher already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-watch-{self.model}",
            daemon=False)
        self._thread.start()
        log_info(f"serve: watching {self.manager.directory!r} for model "
                 f"{self.model!r} every {self.poll_s:g}s")
        return self

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                log_warning(f"serve-watch-{self.model} did not stop within "
                            f"{timeout}s; abandoning it")

    def __enter__(self) -> "CheckpointWatcher":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 — ferried, not fatal
                # poll_once already classifies per-stage failures; this
                # guard is for the unexpected (the watcher thread must
                # survive anything short of interpreter teardown)
                log_warning(f"serve: watcher poll for {self.model!r} "
                            f"failed: {exc!r}")
            self._stop.wait(self.poll_s)

    # -- one poll -------------------------------------------------------------

    def poll_once(self) -> Optional[int]:
        """One watch→validate→warmup→swap cycle; returns the swapped-in
        step, or ``None`` (nothing new, not yet published, or rejected —
        with previous-good untouched in every non-swap outcome)."""
        slot = self.registry.get(self.model)
        stage = "watch"
        try:
            with telemetry.span("model.watch", model=self.model):
                fault.inject("serve.swap", stage="watch", model=self.model)
                step, manifest = self._candidate(slot)
        except Exception as exc:
            self._reject(None, None, stage, exc, slot)
            return None
        if step is None:
            return None
        uri = self.manager.step_uri(step)
        t0 = clock.monotonic()
        try:
            stage = "validate"
            with telemetry.span("model.validate", model=self.model,
                                step=step):
                fault.inject("serve.swap", stage="validate",
                             model=self.model)
                # bytes first (magic/size/CRC, no model work), then the build,
                # then the structural contract — all off-path
                verify_checkpoint(uri, manifest)
                runtime = self.builder(uri)
                CHECK(runtime.num_feature == slot.num_feature,
                      f"candidate serves {runtime.num_feature} features; "
                      f"slot contract is {slot.num_feature}")
            stage = "warmup"
            with telemetry.span("model.warmup", model=self.model,
                                step=step):
                fault.inject("serve.swap", stage="warmup",
                             model=self.model)
                runtime.warmup(slot.batcher.buckets)
            stage = "swap"
            with telemetry.span("model.swap", model=self.model, step=step):
                fault.inject("serve.swap", stage="swap", model=self.model)
                self.registry.swap(self.model, runtime, version=step)
        except Exception as exc:
            self._reject(step, manifest, stage, exc, slot)
            return None
        with self._lock:
            self.swaps_completed += 1
        telemetry.count("dmlc_serve_swap_total", model=self.model,
                        outcome="ok")
        telemetry.observe("dmlc_serve_swap_seconds",
                          clock.monotonic() - t0,
                          buckets=_SWAP_SECONDS_BUCKETS, model=self.model)
        return step

    def _candidate(self, slot):
        """The newest *published, not-known-bad* step above the slot's
        version, manifest included — or ``(None, None)``.

        The scan itself is :meth:`CheckpointManager.latest_valid` (shared
        with the continuous trainer's crash-resume so the fallback-past-
        bad-steps logic exists exactly once).  Newest-first with fallback:
        a rejected newest step must not pin the slot to stale
        previous-good forever when an older valid unswapped step sits in
        the store — e.g. the trainer published v2 then a corrupt v3 and
        stopped.  A step with no manifest yet stops the scan instead of
        being leapfrogged: its write is in flight and swapping to an
        older step now would just churn.
        """
        current = slot.version if isinstance(slot.version, int) else -1
        with self._lock:
            known_bad = frozenset(self._rejected)
        return self.manager.latest_valid(above=current, known_bad=known_bad)

    def _reject(self, step, manifest, stage: str, exc: Exception,
                slot) -> None:
        with self._lock:
            self.rejections += 1
            if step is not None and manifest is not None:
                self._rejected.add((step, manifest.get("crc32")))
        telemetry.count("dmlc_serve_swap_total", model=self.model,
                        outcome="failed")
        telemetry.count("dmlc_serve_swap_failures_total", model=self.model,
                        stage=stage)
        log_warning(
            f"serve: model {self.model!r} candidate "
            f"{'step ' + str(step) if step is not None else 'scan'} "
            f"rejected at {stage}: {exc!r}; previous-good "
            f"(v{slot.version}) keeps serving")
