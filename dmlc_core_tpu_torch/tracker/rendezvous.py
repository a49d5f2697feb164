"""Shard-lease control plane of fleet ingest, wire-compatible framing.

Counterpart of ``dmlc_core_tpu/tracker/rendezvous.py``, cut to what the
fleet-ingest path needs: the int32 / length-prefixed-string framing
(:class:`FramedSocket`, the reference ExSocket), :class:`ProtocolError`,
:class:`TrackerError`, ``LEASE_MAGIC`` 0xFF9A, ``DEFAULT_LEASE_TIMEOUT``,
:func:`bind_free_port` and :class:`ShardLeaseCoordinator`.  The bytes on
the wire are the reference's, so a port worker leases units from a JAX
coordinator and the reverse.  The rabit rendezvous (``RabitTracker``) and
``PSTracker`` are not ported (ROADMAP §1 item 8).

The fault sites ``tracker.framed.recv`` / ``tracker.framed.send``
(:mod:`dmlc_core_tpu_torch.fault`) fire in :class:`FramedSocket` as they do
in the reference.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.telemetry import clock, tracecontext

__all__ = ["FramedSocket", "ProtocolError", "TrackerError", "LEASE_MAGIC",
           "DEFAULT_LEASE_TIMEOUT", "MAX_FRAME", "bind_free_port",
           "ShardLeaseCoordinator"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

# shard-lease control-plane handshake (ShardLeaseCoordinator): distinct from
# the rabit magic 0xFF99 so a worker dialing the wrong port is rejected at
# byte 4
LEASE_MAGIC = 0xFF9A
# the one lease/heartbeat budget default BOTH sides of the lease protocol
# derive from (DMLC_FLEET_LEASE_TIMEOUT overrides; fleet_ingest imports
# this so the coordinator and the workers can never drift apart silently)
DEFAULT_LEASE_TIMEOUT = 10.0
# wire sanity bound: strings in this protocol are worker ids, commands and
# unit specs — anything past it is a corrupt or hostile frame
MAX_FRAME = 1 << 20


class ProtocolError(Exception):
    """A peer violated the lease wire protocol (bad magic, malformed
    frame, impossible count).  Raised — never asserted — so validation
    survives ``python -O`` and the accept loop can reject just that peer."""


class TrackerError(RuntimeError):
    """Structured tracker-level failure: an unreachable lease coordinator,
    or incomplete shard coverage at :meth:`ShardLeaseCoordinator.result`."""


class FramedSocket:
    """int32/length-prefixed-string framing (reference ExSocket).

    ``timeout`` (seconds) bounds every blocking op on the underlying socket;
    inbound string frames are validated against :data:`MAX_FRAME` and UTF-8
    before they reach any caller.
    """

    def __init__(self, sock: socket.socket, timeout: Optional[float] = None):
        self.sock = sock
        if timeout:
            sock.settimeout(timeout)

    def recvall(self, nbytes: int) -> bytes:
        budget = nbytes
        if fault.enabled():
            fault.inject("tracker.framed.recv", nbytes=nbytes)
            budget = fault.truncate("tracker.framed.recv", nbytes)
        chunks = []
        nread = 0
        while nread < budget:
            chunk = self.sock.recv(min(budget - nread, 1024))
            if not chunk:
                raise ConnectionError(
                    f"peer closed during recvall ({nread}/{nbytes} bytes)")
            nread += len(chunk)
            chunks.append(chunk)
        if budget < nbytes:
            # injected truncation models the peer vanishing mid-frame
            raise ConnectionError(
                f"peer closed during recvall ({budget}/{nbytes} bytes)")
        return b"".join(chunks)

    def recvint(self) -> int:
        return struct.unpack("@i", self.recvall(4))[0]

    def _sendall(self, data: bytes) -> None:
        if fault.enabled():
            fault.inject("tracker.framed.send", nbytes=len(data))
        self.sock.sendall(data)

    def sendint(self, n: int) -> None:
        self._sendall(struct.pack("@i", n))

    def sendstr(self, s: str) -> None:
        # length prefix counts encoded BYTES: len(s) would under-count any
        # non-ASCII hostname/jobid and truncate the frame at the receiver
        # (byte-identical to the reference for the ASCII protocol strings)
        data = s.encode()
        self.sendint(len(data))
        self._sendall(data)

    def recvstr(self) -> str:
        n = self.recvint()
        if n < 0 or n > MAX_FRAME:
            raise ProtocolError(
                f"invalid string length {n} on the wire (bounds [0, "
                f"{MAX_FRAME}])")
        data = self.recvall(n)
        try:
            return data.decode()
        except UnicodeDecodeError as exc:
            raise ProtocolError(f"non-UTF-8 string payload: {exc}") from None


def bind_free_port(host: str, port: int = 9091,
                   port_end: int = 9999) -> Tuple[socket.socket, int]:
    """Bind the first free port in [port, port_end) (reference tracker.py:141-152).

    The probe socket is closed on every failure path (exhausted range or a
    non-EADDRINUSE bind error) — only a successful bind transfers ownership
    to the caller.
    """
    family = socket.getaddrinfo(host, None)[0][0]
    sock = socket.socket(family, socket.SOCK_STREAM)
    try:
        for p in range(port, port_end):
            try:
                sock.bind((host, p))
                return sock, p
            except socket.error as err:
                if err.errno in (98, 48):  # EADDRINUSE linux/mac
                    continue
                raise
        raise OSError(f"no free port in [{port}, {port_end})")
    except BaseException:
        sock.close()
        raise


class ShardLeaseCoordinator:
    """Dynamic shard-lease control plane for fleet-scale ingest.

    The data-plane half lives in :mod:`dmlc_core_tpu_torch.parallel.fleet_ingest`;
    this side owns the authoritative unit ledger.  The input is split into
    many more **work units** than workers (byte-range shards or columnar
    row-group units — opaque spec strings here); workers acquire units as
    **heartbeat-renewed leases** over the same framed wire protocol as the
    rabit rendezvous (:class:`FramedSocket`, one short conversation per
    request), and a lease whose holder stops renewing — a worker that died
    mid-unit, or a process wedged hard enough (GC pause, suspended VM,
    partition) that its heartbeat thread misses the lease window — expires
    and is **reassigned** to the next worker that asks.  (A worker whose
    *processor* alone wedges keeps heartbeating and keeps its lease: only
    whole-process trouble triggers handoff, by design — re-ingesting a
    unit someone is still working on would be waste, and the commit
    discipline below makes the race safe if it happens anyway.)
    Coverage is exactly-once-per-committed-unit
    by construction: a unit's first commit wins, a commit from a worker
    that lost its lease is rejected (the worker discards those rows), and a
    commit retry from the committed worker is acked idempotently.

    ``mode="dynamic"`` is the work-stealing scheduler.  ``mode="static"``
    serves the classic ``k % n`` assignment through the *same* wire path
    (each worker may only acquire units with ``unit_id % world_size ==
    worker_index``, and expired leases are never handed to another worker)
    so the ``fleet-ab`` bench A/Bs scheduling policy, not transport.

    Wire conversation (one per TCP connection, any order, any number):

    - handshake: ``int LEASE_MAGIC`` both ways, then ``str worker_id``,
      ``str cmd``;
    - ``acquire``: ``int worker_index`` (used in static mode, ``-1``
      otherwise) -> ``int unit_id`` then, when ``unit_id >= 0``, the
      ``str`` unit spec.  ``-1`` = nothing grantable right now (leases
      outstanding; poll again), ``-2`` = this worker is done (all units —
      all *its* units in static mode — committed);
    - ``renew``: -> ``int`` count of this worker's leases renewed (the
      heartbeat; cadence ``lease_timeout / 3`` on the worker side);
    - ``commit``: ``int unit_id``, ``str payload-json`` (must carry
      ``rows``) -> ``int`` 1 accepted / 0 rejected.

    Like the rendezvous loop, wire violations raise :class:`ProtocolError`
    and reject that connection only; a worker whose lease expired lands in
    :attr:`failed_workers` with a structured message (the
    ``failed_ranks`` idiom from the rendezvous hardening) and is cleared
    if it comes back.  ``DMLC_FLEET_LEASE_TIMEOUT`` (seconds, default
    :data:`DEFAULT_LEASE_TIMEOUT`) is the lease/heartbeat budget;
    per-socket timeouts default to a third of it so one hung
    conversation cannot stall the single-threaded serve loop past a
    heartbeat interval (which would let healthy workers' leases expire
    behind it).
    """

    PENDING, LEASED, COMMITTED = 0, 1, 2

    def __init__(self, host_ip: str, units: List[str], port: int = 9091,
                 port_end: int = 9999, *, mode: str = "dynamic",
                 world_size: int = 0,
                 lease_timeout: Optional[float] = None,
                 sock_timeout: Optional[float] = None):
        if mode not in ("dynamic", "static"):
            raise ValueError(f"mode must be 'dynamic' or 'static', got {mode!r}")
        if mode == "static" and world_size < 1:
            raise ValueError("static mode needs world_size >= 1")
        if not units:
            raise ValueError("no work units to schedule")
        self.host_ip = host_ip
        self.mode = mode
        self.world_size = world_size
        self.lease_timeout = (lease_timeout if lease_timeout is not None
                              else get_env("DMLC_FLEET_LEASE_TIMEOUT",
                                           float, DEFAULT_LEASE_TIMEOUT))
        if self.lease_timeout <= 0:
            raise ValueError("lease_timeout must be > 0")
        # per-connection budget: the serve loop is single-threaded, so one
        # stalled conversation must not outlive a heartbeat interval
        # (lease/3) — otherwise every other worker's renew queues behind
        # it long enough for their leases to expire and be spuriously
        # stolen.  A conversation is a handful of tiny frames sent
        # back-to-back; a third of a lease is generous.
        self.sock_timeout = (sock_timeout if sock_timeout is not None
                             else min(max(self.lease_timeout / 3.0, 0.1),
                                      30.0))
        self._units: List[Dict[str, Any]] = [
            {"spec": str(spec), "status": self.PENDING, "worker": None,
             "deadline": 0.0, "rows": 0, "payload": None, "assigned": 0}
            for spec in units]
        self._lock = threading.Lock()
        self.assigned_total = 0
        self.committed_total = 0
        self.reassigned_total = 0
        self.rejected_total = 0
        # worker id -> structured message for every lease that expired on it
        # (cleared when the worker successfully acquires/renews again — the
        # failed_ranks recover discipline)
        self.failed_workers: Dict[str, str] = {}
        self.error: Optional[str] = None
        self.thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the reference tracker's trace discipline: worker_envs() exports
        # this so every worker's ingest.lease/ingest.unit spans join one timeline
        self.trace = tracecontext.TraceContext(tracecontext.new_trace_id(),
                                               tracecontext.new_span_id())
        self._constructed_at = clock.monotonic()
        n_units = len(self._units)
        # bound LAST (as the reference's trackers are): a constructor
        # failure after the bind would orphan the listening socket
        self.sock, self.port = bind_free_port(host_ip, port, port_end)
        try:
            self.sock.listen(128)
        except BaseException:
            self.sock.close()
            raise
        logger.info("shard-lease coordinator on %s:%d (%d units, %s)",
                    host_ip, self.port, n_units, mode)

    # -- env contract ---------------------------------------------------------
    def worker_envs(self) -> Dict[str, str]:
        return {"DMLC_FLEET_LEASE_URI": self.host_ip,
                "DMLC_FLEET_LEASE_PORT": str(self.port),
                tracecontext.TRACKER_TRACEPARENT_ENV:
                    tracecontext.format_traceparent(self.trace)}

    # -- serve loop -----------------------------------------------------------
    def start(self) -> None:
        # root span recorded NOW (the tracker.start discipline): worker
        # spans parent to it via the exported traceparent and must not
        # depend on the serve loop ever exiting
        telemetry.record_span(
            "ingest.fleet", self._constructed_at, clock.monotonic(),
            trace=(self.trace.trace_id, self.trace.span_id, None),
            units=len(self._units), mode=self.mode, host=self.host_ip,
            port=self.port)
        self.thread = threading.Thread(target=self._serve_loop, daemon=True)
        self.thread.start()

    def _serve_loop(self) -> None:
        try:
            with tracecontext.activate(self.trace):
                self._serve_inner()
        except Exception as exc:  # noqa: BLE001 — ferried to result()
            logger.exception("shard-lease serve loop died")
            # result() polls error from the caller's thread (no join):
            # the crash report rides the same lock as the ledger
            with self._lock:
                self.error = (f"shard-lease serve loop died: "
                              f"{type(exc).__name__}: {exc}")
        finally:
            try:
                self.sock.close()
            except OSError:
                pass

    def _serve_inner(self) -> None:
        # poll accept so stop() (and a closed listener) ends the loop
        self.sock.settimeout(0.1)
        while not self._stop.is_set():
            try:
                fd, addr = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us by stop()
            try:
                self._serve_one(fd, addr)
            except (ProtocolError, ConnectionError, OSError) as err:
                logger.warning("lease request from %s rejected: %s",
                               addr[0], err)
                telemetry.count("dmlc_tracker_protocol_errors_total",
                                reason="lease")
            finally:
                try:
                    fd.close()
                except OSError:
                    pass

    def _serve_one(self, fd: socket.socket, addr) -> None:
        sk = FramedSocket(fd, timeout=self.sock_timeout)
        magic = sk.recvint()
        if magic != LEASE_MAGIC:
            raise ProtocolError(f"invalid lease magic {magic:#x} from {addr[0]}")
        sk.sendint(LEASE_MAGIC)
        worker = sk.recvstr()
        cmd = sk.recvstr()
        if cmd == "acquire":
            widx = sk.recvint()
            unit_id, spec = self._grant(worker, widx)
            sk.sendint(unit_id)
            if unit_id >= 0:
                sk.sendstr(spec)
        elif cmd == "renew":
            sk.sendint(self._renew(worker))
        elif cmd == "commit":
            unit_id = sk.recvint()
            payload = sk.recvstr()
            sk.sendint(1 if self._commit(worker, unit_id, payload) else 0)
        else:
            raise ProtocolError(
                f"unknown lease command {cmd!r} from worker {worker!r}")

    # -- scheduling core (all state under self._lock, no blocking inside) ----
    def _candidates(self, worker_index: int):
        if self.mode == "static":
            if worker_index < 0 or worker_index >= self.world_size:
                raise ProtocolError(
                    f"static acquire needs worker_index in [0, "
                    f"{self.world_size}), got {worker_index}")
            return range(worker_index, len(self._units), self.world_size)
        return range(len(self._units))

    def _grant(self, worker: str, worker_index: int):
        """(unit_id, spec) to serve for an acquire: the worker's own
        already-held lease first (a retry of a lost grant reply must get
        the SAME unit back — see below), else a pending unit, else an
        expired lease (dynamic: stolen from the dead/straggling holder;
        static: only the worker's own), else -1 poll-again / -2 done."""
        candidates = self._candidates(worker_index)
        now = clock.monotonic()
        reassigned_from: Optional[str] = None
        with self._lock:
            # idempotent re-delivery: the worker loop holds at most one
            # lease at a time, so an acquire from a worker that already
            # holds one means the previous grant's reply was lost and the
            # client retried.  Handing out a DIFFERENT unit would orphan
            # the held lease — kept alive forever by the renew-all
            # heartbeat, wedging the epoch — so re-deliver the held unit
            # (deadline refreshed, no counters: it is one grant, retried).
            for i in range(len(self._units)):
                unit = self._units[i]
                if unit["status"] == self.LEASED and unit["worker"] == worker:
                    unit["deadline"] = now + self.lease_timeout
                    logger.debug("re-delivering unit %d to %s (grant retry)",
                                 i, worker)
                    return i, unit["spec"]
            grant = None
            for i in candidates:
                unit = self._units[i]
                if unit["status"] == self.PENDING:
                    grant = i
                    break
                if (unit["status"] == self.LEASED and unit["deadline"] < now
                        and (self.mode == "dynamic"
                             or unit["worker"] == worker)):
                    grant = i
                    if unit["worker"] != worker:
                        reassigned_from = unit["worker"]
                        self.reassigned_total += 1
                        self.failed_workers.setdefault(
                            reassigned_from,
                            f"worker {reassigned_from} lease on unit {i} "
                            f"expired after {self.lease_timeout:g}s; "
                            f"reassigned to {worker}")
                    break
            if grant is None:
                done = all(self._units[i]["status"] == self.COMMITTED
                           for i in candidates)
                return (-2 if done else -1), None
            unit = self._units[grant]
            unit["status"] = self.LEASED
            unit["worker"] = worker
            unit["deadline"] = now + self.lease_timeout
            unit["assigned"] += 1
            self.assigned_total += 1
            # a worker holding a fresh lease is live again
            self.failed_workers.pop(worker, None)
            spec = unit["spec"]
        if reassigned_from is not None:
            logger.warning("unit %d lease expired on %s; reassigned to %s",
                           grant, reassigned_from, worker)
            telemetry.count("dmlc_fleet_units_reassigned_total")
        telemetry.count("dmlc_fleet_units_assigned_total", mode=self.mode)
        return grant, spec

    def _renew(self, worker: str) -> int:
        """Heartbeat: extend every lease this worker still holds.  A lease
        past its deadline but not yet reassigned is revived — the holder is
        demonstrably alive and still the only owner."""
        now = clock.monotonic()
        with self._lock:
            n = 0
            for unit in self._units:
                if unit["status"] == self.LEASED and unit["worker"] == worker:
                    unit["deadline"] = now + self.lease_timeout
                    n += 1
            if n:
                self.failed_workers.pop(worker, None)
        return n

    def _commit(self, worker: str, unit_id: int, payload_json: str) -> bool:
        if unit_id < 0 or unit_id >= len(self._units):
            raise ProtocolError(
                f"commit for unit {unit_id} outside [0, {len(self._units)})")
        try:
            payload = json.loads(payload_json)
            rows = int(payload["rows"])
        except (ValueError, TypeError, KeyError) as exc:
            raise ProtocolError(
                f"malformed commit payload for unit {unit_id}: {exc}") \
                from None
        if rows < 0:
            raise ProtocolError(f"commit for unit {unit_id} with {rows} rows")
        reason = None
        first_commit = False
        with self._lock:
            unit = self._units[unit_id]
            if unit["status"] == self.LEASED and unit["worker"] == worker:
                unit["status"] = self.COMMITTED
                unit["rows"] = rows
                unit["payload"] = payload
                self.committed_total += 1
                first_commit = True
            elif (unit["status"] == self.COMMITTED
                  and unit["worker"] == worker):
                # idempotent ack: the worker's commit landed but the reply
                # was lost and it retried — the ledger already holds the
                # unit exactly once (and the committed counter must not
                # tick again: its contract is units, not acks)
                pass
            else:
                reason = ("already-committed"
                          if unit["status"] == self.COMMITTED
                          else "not-leaseholder")
                self.rejected_total += 1
        if reason is not None:
            logger.warning("rejected commit of unit %d from %s (%s)",
                           unit_id, worker, reason)
            telemetry.count("dmlc_fleet_commits_rejected_total",
                            reason=reason)
            return False
        if first_commit:
            telemetry.count("dmlc_fleet_units_committed_total")
        return True

    # -- results --------------------------------------------------------------
    def coverage(self) -> Tuple[int, int]:
        """(committed units, total units)."""
        with self._lock:
            done = sum(1 for u in self._units
                       if u["status"] == self.COMMITTED)
            return done, len(self._units)

    def ledger(self) -> Dict[int, Dict[str, Any]]:
        """unit_id -> {worker, rows, payload, assigned} for committed units —
        the authoritative exactly-once record."""
        with self._lock:
            return {i: {"worker": u["worker"], "rows": u["rows"],
                        "payload": u["payload"], "assigned": u["assigned"]}
                    for i, u in enumerate(self._units)
                    if u["status"] == self.COMMITTED}

    def result(self, timeout: Optional[float] = None) -> Dict[int, Dict[str, Any]]:
        """Wait for full coverage; return the ledger.  Raises
        :class:`TrackerError` on serve-loop death or when coverage is still
        incomplete at ``timeout`` (naming the uncommitted units and any
        failed workers — a degraded ingest must never read as a clean one)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                error = self.error
                missing = [i for i, u in enumerate(self._units)
                           if u["status"] != self.COMMITTED]
                # snapshot under the lock: the serve thread pops entries
                # when a failed worker comes back, and a raced read here
                # would trade the coverage diagnostic for a KeyError
                failed = dict(self.failed_workers)
            if error:
                raise TrackerError(error)
            if not missing:
                return self.ledger()
            if deadline is not None and time.time() > deadline:
                detail = "; ".join(failed[w] for w in sorted(failed))
                raise TrackerError(
                    f"shard coverage incomplete: {len(missing)} of "
                    f"{len(self._units)} unit(s) uncommitted "
                    f"(e.g. {missing[:8]})"
                    + (f"; failed workers: {detail}" if detail else ""))
            time.sleep(0.05)

    def stop(self) -> None:
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        if self.thread is not None:
            self.thread.join(timeout=5.0)

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()
