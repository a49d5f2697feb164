"""Fleet-scale ingest: dynamic shard leasing with work-stealing workers.

Counterpart of ``dmlc_core_tpu/parallel/fleet_ingest.py``, on the port's
parser, densifier and quantile summaries.  This module is the data-plane
half; the control plane, the authoritative unit ledger with
heartbeat-renewed leases and expiry reassignment, is
:class:`dmlc_core_tpu_torch.tracker.rendezvous.ShardLeaseCoordinator`.
Both speak the reference's framed wire, byte for byte: a port worker leases
from a JAX coordinator and a JAX worker from a port coordinator.

- :func:`plan_units` splits one input URI into many more **work units**
  than workers: each unit is an opaque JSON spec naming a
  ``(part, nparts)`` shard of the URI — byte-range shards for text
  formats (the ``reset_partition`` math), row-group/record-batch units
  for parquet/arrow (the columnar parsers shard ``k % n`` by unit);
- :class:`LeaseClient` speaks the framed lease protocol (one short
  conversation per op, so no lock ever spans a socket read);
- :func:`run_worker` is the worker loop: acquire -> drive the unit
  through ``create_parser`` (the ``DMLC_PARSE_PROC`` fan-out, the remote
  page-cache fetch and columnar ingest engage exactly as they would
  single-host) -> densify -> commit.  A commit rejected because the lease
  expired and moved means those rows are **discarded, not counted**:
  coverage stays exactly-once by construction.  A daemon heartbeat renews
  all held leases every ``lease_timeout / 3``; when the process dies, the
  heartbeat dies with it and the coordinator reassigns.

Observability: ``ingest.lease`` spans bracket waiting for a grant,
``ingest.unit`` spans bracket unit processing, and
``dmlc_fleet_worker_{rows,busy_seconds}_total{worker=...}`` give
per-worker rows/s.  The ``io.fleet.lease`` fault site fires before every
wire op (``ctx: op=, worker=``).

Cross-rank-consistent binning rides along: pass ``binner_bins=`` and the
worker accumulates fixed-size quantile summaries
(:func:`~dmlc_core_tpu_torch.ops.histogram.local_quantile_summary`) over
every densified chunk; :func:`fleet_binner` merges them through
:func:`~dmlc_core_tpu_torch.bridge.binning.fit_binner_from_summaries`.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.tracker.rendezvous import (DEFAULT_LEASE_TIMEOUT,
                                                    LEASE_MAGIC, FramedSocket,
                                                    ProtocolError,
                                                    TrackerError)
from dmlc_core_tpu_torch.utils.logging import log_warning

__all__ = ["plan_units", "LeaseClient", "WorkerResult", "run_worker",
           "default_unit_processor", "fleet_binner"]

def plan_units(uri: str, num_workers: int, *,
               units_per_worker: Optional[int] = None,
               num_units: Optional[int] = None,
               fmt: str = "auto", nthread: int = 1, threaded: bool = False,
               dense_features: Optional[int] = None,
               ledger_labels: bool = False) -> List[str]:
    """Split ``uri`` into work-unit specs (JSON strings) for the coordinator.

    The unit count defaults to ``num_workers * DMLC_FLEET_UNITS_PER_WORKER``
    (8): enough granularity that a straggler sheds load and a dead
    worker's loss re-spreads, without drowning the epoch in per-unit
    parser construction (the reference's sizing table).  Each unit
    is a ``(part, nparts)`` shard: exactly-once coverage of the input is
    the shard math's partition property plus the coordinator's
    exactly-once unit commits.

    ``dense_features`` makes workers densify every block to contiguous
    float32 ``[n, F]`` (the device-ready batch form);
    ``ledger_labels`` adds per-unit label id sum/xor to the commit payload
    (the chaos suite's every-row-exactly-once ground-truth check).
    """
    upw = (units_per_worker if units_per_worker is not None
           else get_env("DMLC_FLEET_UNITS_PER_WORKER", int, 8))
    n = num_units or max(1, num_workers) * max(1, upw)
    spec: Dict[str, Any] = {"uri": uri, "nparts": n, "format": fmt,
                            "nthread": nthread, "threaded": threaded}
    if dense_features:
        spec["dense_features"] = int(dense_features)
    if ledger_labels:
        spec["ledger_labels"] = True
    return [json.dumps(dict(spec, part=k)) for k in range(n)]


class LeaseClient:
    """Framed-protocol client for the shard-lease coordinator.

    One short TCP conversation per op — the heartbeat thread and the main
    loop never share a socket, so no lock spans a blocking read.
    Transient connection failures (including injected ``reset`` faults at
    ``io.fleet.lease``) retry with backoff; wire-protocol violations
    raise :class:`ProtocolError` immediately.
    """

    def __init__(self, host: str, port: int, worker_id: str, *,
                 timeout: float = 30.0, retries: int = 3):
        self.host = host
        self.port = int(port)
        self.worker_id = worker_id
        self.timeout = timeout
        self.retries = retries

    def _op(self, cmd: str, send_fn: Callable[[FramedSocket], None],
            recv_fn: Callable[[FramedSocket], Any]) -> Any:
        last: Optional[BaseException] = None
        for attempt in range(self.retries):
            try:
                # the fault site fires per ATTEMPT, before any byte moves:
                # an 'exit' rule kills this worker while it still holds
                # its leases, a 'reset' raises into the retry path below
                fault.inject("io.fleet.lease", op=cmd, worker=self.worker_id)
                sock = socket.create_connection((self.host, self.port),
                                                timeout=self.timeout)
            except OSError as err:
                last = err
                time.sleep(0.05 * (attempt + 1))
                continue
            try:
                sk = FramedSocket(sock, timeout=self.timeout)
                sk.sendint(LEASE_MAGIC)
                magic = sk.recvint()
                if magic != LEASE_MAGIC:
                    raise ProtocolError(
                        f"bad magic {magic:#x} from lease coordinator "
                        f"{self.host}:{self.port}")
                sk.sendstr(self.worker_id)
                sk.sendstr(cmd)
                send_fn(sk)
                return recv_fn(sk)
            except (ConnectionError, socket.timeout, OSError) as err:
                last = err
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            time.sleep(0.05 * (attempt + 1))
        raise TrackerError(
            f"lease coordinator {self.host}:{self.port} unreachable for "
            f"{cmd!r} after {self.retries} attempts: {last!r} (a "
            "connection closed with no reply can also be the coordinator "
            "REJECTING the request — bad worker_index for a static-mode "
            "coordinator, malformed frame; check its log)")

    def acquire(self, worker_index: int = -1):
        """(unit_id, spec-json|None): ``-1`` = poll again, ``-2`` = done."""
        def recv(sk: FramedSocket):
            unit_id = sk.recvint()
            return unit_id, (sk.recvstr() if unit_id >= 0 else None)

        return self._op("acquire",
                        lambda sk: sk.sendint(worker_index), recv)

    def renew(self) -> int:
        """Heartbeat: renew every lease this worker holds; returns count."""
        return self._op("renew", lambda sk: None,
                        lambda sk: sk.recvint())

    def commit(self, unit_id: int, payload: Dict[str, Any]) -> bool:
        """True when the coordinator accepted this unit's commit."""
        def send(sk: FramedSocket) -> None:
            sk.sendint(unit_id)
            sk.sendstr(json.dumps(payload))

        return self._op("commit", send,
                        lambda sk: sk.recvint() == 1)


class _SummaryAccumulator:
    """Fixed-size quantile summaries over every densified chunk — the
    worker-local half of the cross-rank binner fit."""

    def __init__(self, num_bins: int):
        from dmlc_core_tpu_torch.bridge.binning import default_summary_points

        self.num_bins = num_bins
        self.num_points = default_summary_points(num_bins)
        self._points: List[np.ndarray] = []
        self._counts: List[np.ndarray] = []

    def add(self, x: np.ndarray) -> None:
        from dmlc_core_tpu_torch.ops.histogram import local_quantile_summary

        pts, cnt = local_quantile_summary(np.asarray(x, dtype=np.float32),
                                          self.num_points)
        self._points.append(pts)
        self._counts.append(cnt)

    def absorb(self, other: "_SummaryAccumulator") -> None:
        self._points.extend(other._points)
        self._counts.extend(other._counts)

    def stacked(self):
        if not self._points:
            return None, None
        return np.stack(self._points), np.stack(self._counts)


@dataclass
class WorkerResult:
    """One worker's view of its epoch (the coordinator ledger stays the
    authoritative exactly-once record)."""

    worker_id: str
    rows: int = 0
    units_committed: int = 0
    units_rejected: int = 0
    unit_ids: List[int] = field(default_factory=list)
    busy_seconds: float = 0.0
    summary_points: Optional[np.ndarray] = None   # [C, F, K] when binning
    summary_counts: Optional[np.ndarray] = None   # [C, F]
    binner_bins: Optional[int] = None


def default_unit_processor(spec: Dict[str, Any],
                           accum: Optional[_SummaryAccumulator] = None
                           ) -> Dict[str, Any]:
    """Drive one unit through the port's ingest stack.

    Builds a parser for the unit's ``(part, nparts)`` shard of the URI
    (a byte range of a text file, or row groups/record batches of a
    columnar one).  With ``dense_features`` each block is densified
    to a contiguous float32 ``[n, F]`` array (the form a device copy ships
    as-is) and fed to the binner accumulator when one is active.  Returns
    the commit payload (``rows`` + optional label-id ledger fields).
    """
    from dmlc_core_tpu_torch.bridge.batching import block_to_dense
    from dmlc_core_tpu_torch.data.factory import create_parser

    parser = create_parser(spec["uri"], int(spec.get("part", 0)),
                           int(spec.get("nparts", 1)),
                           type=spec.get("format", "auto"),
                           nthread=int(spec.get("nthread", 1)),
                           threaded=bool(spec.get("threaded", False)))
    rows = 0
    batches = 0
    id_sum = 0
    id_xor = 0
    dense = int(spec.get("dense_features") or 0)
    ledger = bool(spec.get("ledger_labels"))
    try:
        for block in parser:
            rows += block.size
            if ledger and block.size:
                ids = np.asarray(block.label, dtype=np.int64)
                id_sum += int(ids.sum())
                id_xor ^= int(np.bitwise_xor.reduce(ids))
            if dense and block.size:
                x = np.ascontiguousarray(
                    block_to_dense(block, dense).x.numpy(), dtype=np.float32)
                batches += 1
                if accum is not None:
                    accum.add(x)
    finally:
        if hasattr(parser, "close"):
            parser.close()
    payload: Dict[str, Any] = {"rows": rows, "batches": batches}
    if ledger:
        payload["id_sum"] = id_sum
        payload["id_xor"] = id_xor
    return payload


def run_worker(worker_id: str, host: Optional[str] = None,
               port: Optional[int] = None, *,
               worker_index: int = -1,
               processor: Optional[Callable[..., Dict[str, Any]]] = None,
               binner_bins: Optional[int] = None,
               lease_timeout: Optional[float] = None,
               poll_seconds: float = 0.05) -> WorkerResult:
    """Worker loop: acquire -> process -> commit until the coordinator says
    done.  Spawn-safe (plain args), so it is the ``multiprocessing`` /
    launcher target for local fleets and the ``fleet-ab`` bench.

    ``host``/``port`` default to the coordinator's
    ``DMLC_FLEET_LEASE_URI`` / ``DMLC_FLEET_LEASE_PORT`` env contract
    (:meth:`ShardLeaseCoordinator.worker_envs`).  ``worker_index`` only
    matters under a static-mode coordinator (the ``k % n`` residue this
    worker owns).  ``lease_timeout`` must match the coordinator's
    (both default to ``DMLC_FLEET_LEASE_TIMEOUT``); the heartbeat renews
    at a third of it.
    """
    host = host or get_env("DMLC_FLEET_LEASE_URI", str, "127.0.0.1")
    if port is None:
        port = get_env("DMLC_FLEET_LEASE_PORT", int, 0)
    if not port:
        raise ValueError("run_worker needs the coordinator port "
                         "(arg or DMLC_FLEET_LEASE_PORT)")
    lease = (lease_timeout if lease_timeout is not None
             else get_env("DMLC_FLEET_LEASE_TIMEOUT", float,
                          DEFAULT_LEASE_TIMEOUT))
    client = LeaseClient(host, port, worker_id)
    accum = _SummaryAccumulator(binner_bins) if binner_bins else None
    process = processor or default_unit_processor
    result = WorkerResult(worker_id=worker_id, binner_bins=binner_bins)

    stop_hb = threading.Event()

    def _heartbeat() -> None:
        while not stop_hb.wait(lease / 3.0):
            try:
                client.renew()
            except Exception as exc:  # noqa: BLE001 — non-fatal by design
                # recorded, not ferried: a dead coordinator surfaces
                # loudly at the main loop's next wire op either way
                log_warning(f"worker {worker_id}: lease renew failed "
                            f"({exc!r}); leases may expire")

    hb = threading.Thread(target=_heartbeat, daemon=True,
                          name=f"fleet-hb-{worker_id}")
    hb.start()
    wait_start = clock.monotonic()
    try:
        while True:
            unit_id, spec_json = client.acquire(worker_index)
            if unit_id == -2:
                break
            if unit_id == -1:
                time.sleep(poll_seconds)
                continue
            telemetry.record_span("ingest.lease", wait_start,
                                  clock.monotonic(), worker=worker_id,
                                  unit=unit_id)
            spec = json.loads(spec_json)
            # summaries stage into a PER-UNIT accumulator and are absorbed
            # only on an accepted commit: a rejected unit's rows were (or
            # will be) ingested by the lease's new holder, and keeping its
            # summaries here would double that unit's mass in the fleet
            # binner edges
            unit_accum = (_SummaryAccumulator(binner_bins) if binner_bins
                          else None)
            t0 = clock.monotonic()
            with telemetry.span("ingest.unit", worker=worker_id,
                                unit=unit_id) as sp:
                payload = process(spec, unit_accum)
                sp.set(rows=payload.get("rows", 0))
            busy = clock.monotonic() - t0
            if client.commit(unit_id, payload):
                if accum is not None:
                    accum.absorb(unit_accum)
                result.rows += int(payload.get("rows", 0))
                result.units_committed += 1
                result.unit_ids.append(unit_id)
                result.busy_seconds += busy
                telemetry.count("dmlc_fleet_worker_rows_total",
                                int(payload.get("rows", 0)),
                                worker=worker_id)
                telemetry.count("dmlc_fleet_worker_busy_seconds_total",
                                busy, worker=worker_id)
            else:
                # the lease expired and moved while we processed: the unit
                # is (or will be) committed by its new holder — counting
                # these rows too would double them, so they are discarded
                result.units_rejected += 1
                log_warning(f"worker {worker_id}: commit of unit {unit_id} "
                            "rejected (lease moved); rows discarded")
            wait_start = clock.monotonic()
    finally:
        stop_hb.set()
        hb.join(timeout=2.0)
    if accum is not None:
        result.summary_points, result.summary_counts = accum.stacked()
    return result


def fleet_binner(result: WorkerResult, *, comm=None,
                 handle_missing: bool = False):
    """Fit this rank's :class:`HostBinner` from the summaries a
    ``binner_bins``-enabled :func:`run_worker` accumulated.

    With a rabit-shaped ``comm`` the merge is the
    :func:`fit_binner_from_summaries` allgather path: every rank returns
    bitwise-identical edges even though dynamic leasing gave each a
    different unit set (the cross-rank-consistency contract of
    ``fit_binner(comm=...)``, now multi-worker for real).

    Only committed units contribute (a rejected unit's summaries are
    dropped — its rows belong to the lease's new holder), and only the
    zero-fill densification is supported: ``handle_missing=True`` needs
    NaN-filled chunks (missing carries no rank mass), which the fleet
    processor does not produce — it raises rather than return
    silently-skewed edges.
    """
    from dmlc_core_tpu_torch.bridge.binning import fit_binner_from_summaries

    if handle_missing:
        raise ValueError(
            "fleet_binner does not support handle_missing=True: the fleet "
            "processor densifies absent features to 0.0, so the "
            "accumulated summaries carry fabricated zero mass where the "
            "missing-bin contract needs NaN (zero mass); fit the missing-"
            "aware binner with bridge.binning.fit_binner over the source")
    if result.binner_bins is None or result.summary_points is None:
        raise ValueError(
            "fleet_binner needs a run_worker(binner_bins=...) result that "
            "ingested at least one dense chunk")
    return fit_binner_from_summaries(
        result.summary_points, result.summary_counts, result.binner_bins,
        comm=comm)
