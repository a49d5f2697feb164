"""Continuous trainer daemon: crash-tolerant GBDT refresh, end to end.

Counterpart of ``dmlc_core_tpu/train/daemon.py`` on the port's ``GBDT``:
:class:`TrainerDaemon` consumes dense batches from a
:mod:`~dmlc_core_tpu_torch.train.source` (spool directory or the
shard-lease fleet), appends incremental boosting rounds on the card
(:meth:`~dmlc_core_tpu_torch.models.gbdt.GBDT.append_rounds`: binner edges
frozen, uint8 serving wire bitwise skew-free) and publishes manifest-first
checkpoints the :class:`~dmlc_core_tpu_torch.serve.lifecycle.
CheckpointWatcher` validates and swaps with zero dropped requests.  The
blobs are the reference's format, so either package's daemon resumes
from either package's steps.

``device`` is where the rounds run: ``cuda`` unless the caller passes
``device="cpu"``.  The ensemble lives there; the publish clock thread's
``serving_state`` copies it to the host, which waits for the rounds
queued before it on the stream.  Each round's ensemble is a new set of
tensors, replaced wholesale under the lock and never written again, so
the clock never reads a tensor a later round still writes.

Crash tolerance is by construction, not by cleanup:

resume
    startup scans for the last *valid* manifest
    (:meth:`CheckpointManager.latest_valid`, the same fallback-past-bad-
    steps scan the serving watcher runs, plus a byte re-hash), restores
    trees + frozen edges + the ingest cursor from it, and retrains only
    the rounds published state never saw.  A manifest-less newest step
    (the previous incarnation died mid-publish) is skipped AND its step
    number is reused: the interrupted publish completes idempotently.
publish
    temp + verify + manifest-last: the blob lands via atomic
    temp+rename, is re-hashed against its own digest, and only then gets
    a manifest.  A kill at ANY point mid-publish leaves a step the
    manifest-first watcher never even opens.  A verify failure
    (torn/bit-rotted blob) rejects the publish, counts it, and the same
    step is re-published on the next cadence.
poison
    a batch that fails to parse, has the wrong feature arity, a
    non-finite label, or non-finite features outside the
    ``handle_missing`` contract is quarantined and counted
    (``dmlc_train_quarantined_total``), never fatal; the cursor advances
    past it.

Fault sites ``train.ingest`` / ``train.round`` / ``train.publish`` ride
the :mod:`~dmlc_core_tpu_torch.fault` plan machinery; every stage is a
``train.*`` span and the odometers flush as ``dmlc_train_*`` metrics.

Knobs: ``DMLC_TRAIN_PUBLISH_EVERY_S`` (wall-clock publish cadence, 0 =
off — a daemon thread snapshots and publishes even while ingest idles),
``DMLC_TRAIN_PUBLISH_ROUNDS`` (publish every N boosting rounds, default
8), ``DMLC_TRAIN_POLL_S`` (idle source poll, default 0.5).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                   load_checkpoint,
                                                   save_checkpoint,
                                                   verify_checkpoint)
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.train.source import Batch
from dmlc_core_tpu_torch.utils.logging import CHECK, log_info, log_warning

__all__ = ["TrainerDaemon", "CURSOR_KEY", "ROUND_KEY"]

# serving_state extra leaves: the ingest cursor and round odometer ride
# the same atomic blob as the trees they produced — resume state and
# model state can never diverge
CURSOR_KEY = "train_cursor"
ROUND_KEY = "train_round"

DEFAULT_PUBLISH_ROUNDS = 8
DEFAULT_POLL_S = 0.5


def _strip_local(uri: str) -> str:
    return uri[7:] if uri.startswith("file://") else uri


class TrainerDaemon:
    """The continuous training loop: ingest → boost → publish, survivable
    at every instruction boundary.

    ``source`` is any object with ``next_batch(cursor) -> Batch | None``
    and ``exhausted(cursor) -> bool`` (:class:`~dmlc_core_tpu_torch.
    train.source.DirectorySource` / :class:`~.source.FleetSource`).
    ``param`` carries the boosting hyperparameters; on resume its
    structural fields must match the restored checkpoint
    (:meth:`GBDT.resume` refuses a mismatch — the serving wire contract is
    frozen by the checkpoint).  ``device`` is where the rounds run
    (``cuda`` unless ``device="cpu"``).
    """

    def __init__(self, directory: str, source: Any, num_feature: int, *,
                 param: Optional[GBDTParam] = None,
                 manager: Optional[CheckpointManager] = None,
                 rounds_per_batch: int = 1,
                 publish_every_rounds: Optional[int] = None,
                 publish_every_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 keep: int = 8,
                 incarnation: int = 0,
                 state_file: Optional[str] = None,
                 device=None):
        CHECK(rounds_per_batch >= 1, "rounds_per_batch must be >= 1")
        self.device = device
        self.source = source
        self.num_feature = num_feature
        self.incarnation = incarnation
        self.state_file = state_file
        self.rounds_per_batch = rounds_per_batch
        self.publish_every_rounds = (
            publish_every_rounds if publish_every_rounds is not None
            else get_env("DMLC_TRAIN_PUBLISH_ROUNDS", int,
                         DEFAULT_PUBLISH_ROUNDS))
        self.publish_every_s = (
            publish_every_s if publish_every_s is not None
            else get_env("DMLC_TRAIN_PUBLISH_EVERY_S", float, 0.0))
        self.poll_s = (poll_s if poll_s is not None
                       else get_env("DMLC_TRAIN_POLL_S", float,
                                    DEFAULT_POLL_S))
        CHECK(self.poll_s > 0, "poll_s must be > 0")
        self.manager = manager or CheckpointManager(directory, keep=keep)
        param = param or GBDTParam()
        # guards every piece of mutable training state: the publish clock
        # thread snapshots model+cursor while the ingest loop trains, and
        # both sides bump the progress odometers
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._clock: Optional[threading.Thread] = None
        #: public progress odometers (lock-guarded; mirrored to
        #: ``dmlc_train_*`` counters and the ``state_file`` snapshot)
        self.rounds_completed = 0
        self.publishes_completed = 0
        self.publish_rejections = 0
        self.quarantined = 0
        self.ingest_failures = 0
        #: the step resume restored from (None = cold start)
        self.resumed_from: Optional[int] = None
        self._ensemble: Optional[TreeEnsemble] = None
        self._cursor = 0
        self._published_rounds = 0
        self._next_step = 1
        self._gbdt = GBDT(param, num_feature, device=device)
        self._resume(param)
        self._write_state_file()

    # -- resume ---------------------------------------------------------------

    def _resume(self, param: GBDTParam) -> None:
        """Restore from the last *valid* manifest, exactly like the
        serving watcher scans (shared ``latest_valid``), plus a byte
        re-hash: corrupt or torn steps are fallen past, a manifest-less
        newest step (a dead incarnation's interrupted publish) is skipped
        — and its step number reused, so the publish completes
        idempotently on the next cadence."""
        with telemetry.span("train.resume", incarnation=self.incarnation):
            step, manifest = self.manager.latest_valid(
                verify=True, skip_unpublished=True)
            steps = self.manager.all_steps()
            if step is None:
                # cold start: boundaries are fit from the first healthy
                # batch; any abandoned blobs still claim their numbers.
                # __init__ runs before the clock thread exists, but every
                # write to the shared state rides the lock anyway — one
                # lockset per field, no special cases
                with self._lock:
                    self._next_step = (steps[-1] + 1) if steps else 1
                    next_step = self._next_step
                log_info("train: cold start (no valid checkpoint); "
                         f"first publish will be step {next_step}")
                return
            flat = load_checkpoint(self.manager.step_uri(step))
            gbdt, ensemble = GBDT.resume(flat, param=param,
                                         device=self.device)
            CHECK(gbdt.num_feature == self.num_feature,
                  f"checkpoint serves {gbdt.num_feature} features; "
                  f"this trainer ingests {self.num_feature}")
            cursor = flat.get(f"['{CURSOR_KEY}']")
            rounds = flat.get(f"['{ROUND_KEY}']")
            restored_cursor = int(np.asarray(cursor).reshape(-1)[0]) \
                if cursor is not None else 0
            restored_rounds = int(np.asarray(rounds).reshape(-1)[0]) \
                if rounds is not None else ensemble.num_trees
            # abandoned manifest-LESS steps above the restored one get
            # overwritten, not leapfrogged: re-publish is idempotent.  A
            # manifested-but-corrupt step keeps its number retired — it
            # was once published, so a serving slot may carry it as a
            # live version; rewriting it with different trees would make
            # that version ambiguous.  Fresh work goes above it.
            newest = steps[-1] if steps else step
            orphans = [s for s in steps if s > step
                       and self.manager.read_manifest(s) is None]
            with self._lock:
                self._gbdt = gbdt
                self._ensemble = ensemble
                self._cursor = restored_cursor
                self.rounds_completed = restored_rounds
                self._published_rounds = restored_rounds
                self.resumed_from = step
                self._next_step = min(orphans) if orphans else newest + 1
                next_step = self._next_step
            telemetry.gauge_set("dmlc_train_resumed_step", step)
            log_info(f"train: resumed from step {step} "
                     f"(rounds={restored_rounds}, "
                     f"cursor={restored_cursor}, next step "
                     f"{next_step})")

    # -- lifecycle ------------------------------------------------------------

    def start_clock(self) -> "TrainerDaemon":
        """Start the wall-clock publish thread (``publish_every_s``);
        no-op when the cadence is 0/off."""
        if self.publish_every_s and self.publish_every_s > 0:
            CHECK(self._clock is None or not self._clock.is_alive(),
                  "publish clock already running")
            self._clock = threading.Thread(
                target=self._publish_clock,
                name=f"train-publish-{self.incarnation}", daemon=False)
            self._clock.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        clock, self._clock = self._clock, None
        if clock is not None:
            clock.join(timeout)
            if clock.is_alive():
                log_warning("train: publish clock did not stop within "
                            f"{timeout}s; abandoning it")

    def __enter__(self) -> "TrainerDaemon":
        return self.start_clock()

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _publish_clock(self) -> None:
        while not self._stop.wait(self.publish_every_s):
            try:
                self.publish_now()
            except Exception as exc:  # noqa: BLE001 — ferried, not fatal
                log_warning(f"train: cadence publish failed: {exc!r}")

    # -- the loop -------------------------------------------------------------

    def run(self, *, max_batches: int = 0,
            exit_when_idle: bool = False) -> None:
        """Ingest→boost→publish until stopped.  ``max_batches`` bounds
        consumed batches (0 = unbounded); ``exit_when_idle`` returns once
        the source reports itself exhausted (batch-job drain) — with a
        final publish so nothing trained is left unpublished."""
        consumed = 0
        self.start_clock()
        try:
            while not self._stop.is_set():
                progressed = self.step_once()
                if progressed:
                    consumed += 1
                    if max_batches and consumed >= max_batches:
                        break
                    continue
                if exit_when_idle and self.source.exhausted(self._cursor):
                    break
                self._stop.wait(self.poll_s)
        finally:
            self.close()
            self.publish_now()   # drain: publish whatever trained last
            self._write_state_file()

    def step_once(self) -> bool:
        """One ingest+train step; True when a batch was consumed (healthy
        or quarantined), False when the source had nothing new."""
        batch = self._ingest_once()
        if batch is None:
            return False
        if not self._healthy(batch):
            return True
        self._train_on(batch)
        due = False
        with self._lock:
            if (self.publish_every_rounds and
                    self.rounds_completed - self._published_rounds
                    >= self.publish_every_rounds):
                due = True
        if due:
            self.publish_now()
        self._write_state_file()
        return True

    def _ingest_once(self) -> Optional[Batch]:
        with telemetry.span("train.ingest", cursor=self._cursor):
            try:
                fault.inject("train.ingest", cursor=self._cursor,
                             incarnation=self.incarnation)
                return self.source.next_batch(self._cursor)
            except Exception as exc:  # noqa: BLE001 — retried next tick
                with self._lock:
                    self.ingest_failures += 1
                telemetry.count("dmlc_train_ingest_failures_total")
                log_warning(f"train: ingest at cursor {self._cursor} "
                            f"failed ({exc!r}); retrying next tick")
                return None

    def _healthy(self, batch: Batch) -> bool:
        """Poison gate: quarantine-and-count, never fatal.  The cursor
        advances past the batch either way — a poisoned file must not
        wedge the ring."""
        reason = batch.error
        if reason is None:
            x, label = batch.x, batch.label
            if x.ndim != 2 or x.shape[1] != self.num_feature:
                reason = (f"feature arity {x.shape} != "
                          f"[n, {self.num_feature}] (schema drift)")
            elif x.dtype != np.float32:
                reason = f"dtype drift: {x.dtype} is not float32"
            elif label is None or not np.all(np.isfinite(label)):
                reason = "non-finite label"
            elif (not self._gbdt.param.handle_missing
                  and not np.all(np.isfinite(x))):
                reason = ("non-finite features without handle_missing "
                          "(NaN would poison binning)")
            elif np.any(np.isinf(x)):
                reason = "infinite feature values"
        if reason is None:
            return True
        with self._lock:
            self.quarantined += 1
            self._cursor = batch.cursor
        telemetry.count("dmlc_train_quarantined_total")
        telemetry.event("train.quarantined", origin=batch.origin,
                        reason=reason)
        log_warning(f"train: quarantined batch {batch.origin!r}: {reason}")
        return False

    def _train_on(self, batch: Batch) -> None:
        """Append ``rounds_per_batch`` boosting rounds on one batch.  The
        ensemble is replaced wholesale under the lock (never mutated), so
        the publish clock can snapshot mid-training safely."""
        if self._gbdt.boundaries is None:
            # cold start: quantile edges fit once, frozen forever after —
            # every later batch and every serving binner sees these exact
            # edges (the bitwise skew-free wire contract).  The fit rides
            # the lock: the publish clock reads boundaries through
            # serving_state, and this is the one write after threads start
            with self._lock:
                self._gbdt.make_bins(batch.x)
            log_info(f"train: fit {self.num_feature}-feature bin edges "
                     f"from first batch {batch.origin!r}")
        bins = self._gbdt.bin_features(batch.x)
        ensemble, margin = self._ensemble, None
        start = self.rounds_completed
        for r in range(self.rounds_per_batch):
            with telemetry.span("train.round", round=start + r):
                fault.inject("train.round", round=start + r,
                             incarnation=self.incarnation)
                ensemble, margin = self._gbdt.append_rounds(
                    ensemble, bins, batch.label, num_rounds=1,
                    margin=margin, start_round=start + r)
            telemetry.count("dmlc_train_rounds_total")
        with self._lock:
            self._ensemble = ensemble
            self._cursor = batch.cursor
            self.rounds_completed += self.rounds_per_batch
        telemetry.gauge_set("dmlc_train_cursor", batch.cursor)
        telemetry.gauge_set("dmlc_train_trees", ensemble.num_trees)

    # -- publish --------------------------------------------------------------

    def publish_now(self) -> Optional[int]:
        """Publish the current model if it has trained past the last
        published state; returns the published step or ``None`` (nothing
        new, or the publish was rejected by its own verify).

        Runs on the ingest loop (every-N-rounds cadence) AND the publish
        clock thread — the snapshot and the odometers are lock-guarded;
        the store IO runs outside the lock (training never stalls on a
        slow store)."""
        with self._lock:
            if (self._ensemble is None
                    or self.rounds_completed <= self._published_rounds):
                return None
            ensemble = self._ensemble
            cursor = self._cursor
            rounds = self.rounds_completed
            step = self._next_step
        state = self._gbdt.serving_state(ensemble, extra={
            CURSOR_KEY: np.array([cursor], np.int64),
            ROUND_KEY: np.array([rounds], np.int64)})
        try:
            with telemetry.span("train.publish", step=step):
                self._write_step(step, state)
        except Exception as exc:  # noqa: BLE001 — rejected, retried
            with self._lock:
                self.publish_rejections += 1
            telemetry.count("dmlc_train_publish_total", outcome="rejected")
            log_warning(f"train: publish of step {step} rejected "
                        f"({exc!r}); will re-publish the same step")
            return None
        with self._lock:
            self.publishes_completed += 1
            self._published_rounds = rounds
            self._next_step = step + 1
        telemetry.count("dmlc_train_publish_total", outcome="ok")
        log_info(f"train: published step {step} (rounds={rounds}, "
                 f"cursor={cursor})")
        self._write_state_file()
        return step

    def _write_step(self, step: int, state: Dict[str, Any]) -> None:
        """temp + verify + manifest-last.  A kill before the manifest
        write leaves an unpublished step no manifest-first reader opens;
        an injected (or real) torn write fails the verify and the step is
        re-published from scratch next cadence."""
        uri = self.manager.prepare_step(step)
        fault.inject("train.publish", step=step, phase="begin",
                     incarnation=self.incarnation)
        summary = save_checkpoint(uri, state)
        fault.inject("train.publish", step=step, phase="durable",
                     incarnation=self.incarnation)
        keep = fault.truncate("train.publish", summary["nbytes"],
                              step=step, phase="durable",
                              incarnation=self.incarnation)
        if keep < summary["nbytes"]:
            # chaos only: tear the durable blob the way a dying disk or a
            # non-atomic remote store would, BEFORE the verify
            with open(_strip_local(uri), "r+b") as f:
                f.truncate(keep)
        verify_checkpoint(uri, summary)
        self.manager.publish(step, summary)

    # -- introspection --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "incarnation": self.incarnation,
                "resumed_from": self.resumed_from,
                "cursor": self._cursor,
                "rounds_completed": self.rounds_completed,
                "publishes_completed": self.publishes_completed,
                "publish_rejections": self.publish_rejections,
                "quarantined": self.quarantined,
                "ingest_failures": self.ingest_failures,
                "next_step": self._next_step,
                "trees": (self._ensemble.num_trees
                          if self._ensemble is not None else 0),
            }

    def _write_state_file(self) -> None:
        """Atomic progress snapshot for supervisors (the chaos drill
        asserts resume provenance from it after every kill)."""
        if not self.state_file:
            return
        tmp = f"{self.state_file}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.describe(), f, indent=1, sort_keys=True)
        os.replace(tmp, self.state_file)
