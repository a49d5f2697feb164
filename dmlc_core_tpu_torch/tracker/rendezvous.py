"""Rank rendezvous + topology service and the shard-lease control plane.

Counterpart of ``dmlc_core_tpu/tracker/rendezvous.py``, whole.  The bytes
on the wire are the reference's, so a Rabit client (an XGBoost binary, or
a worker of either package) rendezvous against this tracker unchanged, and
a port worker leases fleet-ingest units from a JAX coordinator and the
reverse:

- framed socket protocol: native-endian int32s and length-prefixed strings
  (:class:`FramedSocket`, the reference ExSocket), handshake magic
  :data:`MAGIC` 0xff99;
- :class:`RabitTracker`: the commands ``start`` / ``recover`` / ``print``
  / ``shutdown``, batch rank assignment sorted by host with jobid -> rank
  recovery (:meth:`WorkerEntry.resolve_rank`), the binary tree + parent
  map and the tree-sharing ring relabelled so ring order is rank order
  (:meth:`RabitTracker.get_link_map`), and the link-brokering rounds that
  repeat until every rank reports all its links connected;
- :class:`PSTracker`: the ps-lite scheduler bootstrap;
- :class:`ShardLeaseCoordinator`: heartbeat-renewed leases of ingest units
  over the same framing (``LEASE_MAGIC`` 0xFF9A).

The control plane is deadline-hardened as the reference's is: wire
violations raise :class:`ProtocolError` and reject that connection only;
``DMLC_TRACKER_SOCK_TIMEOUT`` bounds every per-socket wait;
``DMLC_TRACKER_RENDEZVOUS_DEADLINE`` bounds the whole rendezvous with a
clean shutdown; a worker dying mid-brokering fails that rank in
:attr:`RabitTracker.failed_ranks` instead of hanging the world.  The fault
sites ``tracker.framed.recv`` / ``tracker.framed.send`` /
``tracker.accept`` (:mod:`dmlc_core_tpu_torch.fault`) fire where they fire
in the reference, and the spans (``tracker.start``,
``tracker.rendezvous``, ``rendezvous.connect|assign|barrier``) and series
(``dmlc_rendezvous_*``, ``dmlc_tracker_*``) keep the reference's names.

The port's own workers never dial the rabit links: they read the env
contract (:func:`RabitTracker.worker_envs` plus the coordinator address
that :mod:`.submit` adds) and join one ``torch.distributed`` process group
(:mod:`dmlc_core_tpu_torch.collective`).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.telemetry import clock, tracecontext

__all__ = ["FramedSocket", "ProtocolError", "TrackerError", "MAGIC",
           "LEASE_MAGIC", "DEFAULT_LEASE_TIMEOUT", "MAX_FRAME", "MAX_PEERS",
           "MAX_BROKER_ROUNDS", "WorkerEntry", "bind_free_port",
           "RabitTracker", "ShardLeaseCoordinator", "PSTracker"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

MAGIC = 0xFF99
# shard-lease control-plane handshake (ShardLeaseCoordinator): distinct from
# the rabit MAGIC so a worker dialing the wrong port is rejected at byte 4
LEASE_MAGIC = 0xFF9A
# the one lease/heartbeat budget default BOTH sides of the lease protocol
# derive from (DMLC_FLEET_LEASE_TIMEOUT overrides; fleet_ingest imports
# this so the coordinator and the workers can never drift apart silently)
DEFAULT_LEASE_TIMEOUT = 10.0
# wire sanity bounds: strings in this protocol are job ids / commands /
# hostnames and peer counts are world-sized — anything past these is a
# corrupt or hostile frame, not a big job
MAX_FRAME = 1 << 20
MAX_PEERS = 1 << 16
# brokering rounds before the tracker gives up on a conversation: an honest
# client converges in a handful of rounds; an endless nerr!=0 loop means its
# dial targets are gone (e.g. a peer process died after registering)
MAX_BROKER_ROUNDS = 256


class ProtocolError(Exception):
    """A peer violated the rendezvous wire protocol (bad magic, malformed
    frame, impossible count).  Raised — never asserted — so validation
    survives ``python -O`` and the accept loop can reject just that peer."""


class TrackerError(RuntimeError):
    """Structured tracker-level failure surfaced by :meth:`RabitTracker.join`
    (rendezvous deadline exceeded, or workers failed mid-rendezvous)."""


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


def _resolve_ip(host: str) -> str:
    return socket.getaddrinfo(host, None)[0][4][0]


class WorkerEntry:
    """One connected worker: the handshake state plus the per-worker half of
    the link-brokering conversation (wire-compatible with Rabit's client
    side; message sequence documented on each method)."""

    def __init__(self, sock: socket.socket, addr,
                 timeout: Optional[float] = None):
        connect_start = clock.monotonic()
        self.sock = FramedSocket(sock, timeout=timeout)
        self.host = _resolve_ip(addr[0])
        magic = self.sock.recvint()
        if magic != MAGIC:
            raise ProtocolError(f"invalid magic {magic:#x} from {self.host}")
        self.sock.sendint(MAGIC)
        self.rank = self.sock.recvint()
        self.world_size = self.sock.recvint()
        self.jobid = self.sock.recvstr()
        self.cmd = self.sock.recvstr()
        # connect-phase bracket, attributed to a rank once one is assigned
        # (assign_rank emits the span) — the per-rank rendezvous timeline is
        # connect -> assign -> barrier in the exported trace
        self.connect_span = (connect_start, clock.monotonic())
        # inbound links this worker still expects peers to dial (it stays in
        # the tracker's accept registry until this reaches zero)
        self.pending_accepts = 0
        # the worker's own listening port, reported at the end of brokering
        self.port: Optional[int] = None

    def resolve_rank(self, jobid_ranks: Dict[str, int]) -> int:
        """Keep a self-reported rank, else restore a restarted worker's old
        rank by job id, else -1 (rank to be assigned in host order)."""
        if self.rank >= 0:
            return self.rank
        return jobid_ranks.get(self.jobid, -1) if self.jobid != "NULL" else -1

    def send_topology(self, rank: int, world: int, tree_links: List[int],
                      parent: int, ring_prev: int, ring_next: int) -> set:
        """Push the assigned rank and its neighborhood down the wire.

        Wire order (fixed by the Rabit client): rank, parent, world size,
        tree-degree, each tree neighbor, ring-prev, ring-next — the ring
        slots carry -1 when absent or self-referential.  Returns the full
        link set (tree + real ring hops) this worker must establish.
        """
        self.rank = rank
        links = set(tree_links)
        self.sock.sendint(rank)
        self.sock.sendint(parent)
        self.sock.sendint(world)
        self.sock.sendint(len(links))
        # iterate the SET, not the list: the neighbor block is a set on the
        # wire, and the reference tracker emits it in set-iteration order —
        # doing the same keeps conversations byte-identical to it
        # (tests/test_tracker_conformance.py)
        for peer in links:
            self.sock.sendint(peer)
        for hop in (ring_prev, ring_next):
            if hop in (-1, rank):
                self.sock.sendint(-1)
            else:
                self.sock.sendint(hop)
                links.add(hop)
        return links

    def broker_links(self, links: set,
                     accept_registry: Dict[int, "WorkerEntry"]) -> List[int]:
        """Run brokering rounds until this worker's dial attempts all
        succeed.

        Each round: the worker reports which peers it already reached; the
        tracker answers with the subset of its missing peers that are
        listening right now (count, then host/port/rank triples) plus how
        many peers are not yet dialable (the worker must accept those
        inbound later).  A round that ends with connect errors repeats;
        a clean round ends with the worker reporting its own listening
        port.  Bookkeeping after a clean round: every peer this worker was
        told to dial has one fewer inbound accept outstanding — peers that
        reach zero are fully linked and leave ``accept_registry``; this
        worker records its own outstanding inbound count.  Returns the
        ranks that became fully linked.

        Everything the peer reports is validated (counts bounded, reported
        peers must be assigned links) and a conversation that never
        converges is cut off after :data:`MAX_BROKER_ROUNDS` — both raise
        :class:`ProtocolError`, which the accept loop turns into a failed
        rank rather than a dead tracker.
        """
        for _ in range(MAX_BROKER_ROUNDS):
            nreached = self.sock.recvint()
            if nreached < 0 or nreached > MAX_PEERS:
                raise ProtocolError(
                    f"rank {self.rank} reported {nreached} reached peers")
            reached = {self.sock.recvint() for _ in range(nreached)}
            if not reached <= links:
                raise ProtocolError(
                    f"rank {self.rank} reported links it was never "
                    f"assigned: {sorted(reached - links)}")
            missing = links - reached
            dialable = [peer for peer in missing if peer in accept_registry]
            self.sock.sendint(len(dialable))
            self.sock.sendint(len(missing) - len(dialable))
            for peer in dialable:
                listener = accept_registry[peer]
                self.sock.sendstr(listener.host)
                self.sock.sendint(listener.port)
                self.sock.sendint(peer)
            dial_errors = self.sock.recvint()
            if dial_errors != 0:
                continue
            self.port = self.sock.recvint()
            fully_linked = []
            for peer in dialable:
                listener = accept_registry[peer]
                listener.pending_accepts -= 1
                if listener.pending_accepts == 0:
                    fully_linked.append(peer)
            for peer in fully_linked:
                accept_registry.pop(peer, None)
            self.pending_accepts = len(missing) - len(dialable)
            return fully_linked
        raise ProtocolError(
            f"rank {self.rank} brokering did not converge within "
            f"{MAX_BROKER_ROUNDS} rounds (dial targets unreachable?)")

    def assign_rank(self, rank: int,
                    accept_registry: Dict[int, "WorkerEntry"],
                    tree_map, parent_map, ring_map) -> List[int]:
        telemetry.record_span("rendezvous.connect", *self.connect_span,
                              rank=rank, host=self.host, cmd=self.cmd)
        assign_start = clock.monotonic()
        ring_prev, ring_next = ring_map[rank]
        links = self.send_topology(rank, len(tree_map), tree_map[rank],
                                   parent_map[rank], ring_prev, ring_next)
        out = self.broker_links(links, accept_registry)
        telemetry.record_span("rendezvous.assign", assign_start,
                              clock.monotonic(), rank=rank,
                              links=len(links))
        if telemetry.enabled():
            telemetry.observe("dmlc_rendezvous_assign_seconds",
                              clock.elapsed(assign_start))
            telemetry.count("dmlc_rendezvous_workers_total", cmd=self.cmd)
        return out


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


class RabitTracker:
    """The rendezvous server (reference RabitTracker, tracker.py:137-334).

    Robustness knobs (docs/robustness.md; constructor args override env):

    - ``sock_timeout`` / ``DMLC_TRACKER_SOCK_TIMEOUT`` (seconds, 0 = off):
      applied to every accepted socket, so a client that connects and goes
      silent times out instead of freezing the single-threaded accept loop;
    - ``rendezvous_deadline`` / ``DMLC_TRACKER_RENDEZVOUS_DEADLINE``
      (seconds, 0 = off): armed when the first worker knocks, disarmed once
      all ranks started; while armed, every accepted socket's timeout is
      additionally clamped to the remaining deadline, so even a hung
      conversation cannot block the loop past it.  On expiry the tracker
      closes every pending worker's socket (they observe a connection
      error — a structured failure, not a hang), records :attr:`error`,
      and shuts down cleanly; :meth:`join` then raises
      :class:`TrackerError`.

    After the run, :attr:`failed_ranks` maps each rank that died
    mid-rendezvous to a structured message; :meth:`join` raises
    :class:`TrackerError` when any exist, so callers cannot mistake a
    degraded rendezvous for a clean one.
    """

    def __init__(self, host_ip: str, num_workers: int, port: int = 9091,
                 port_end: int = 9999,
                 sock_timeout: Optional[float] = None,
                 rendezvous_deadline: Optional[float] = None):
        self.host_ip = host_ip
        self.num_workers = num_workers
        self.thread: Optional[threading.Thread] = None
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.sock_timeout = (sock_timeout if sock_timeout is not None
                             else get_env("DMLC_TRACKER_SOCK_TIMEOUT",
                                          float, 0.0))
        self.rendezvous_deadline = (
            rendezvous_deadline if rendezvous_deadline is not None
            else get_env("DMLC_TRACKER_RENDEZVOUS_DEADLINE", float, 0.0))
        # rank -> structured message for every worker that died mid-rendezvous
        self.failed_ranks: Dict[int, str] = {}
        # tracker-fatal condition (rendezvous deadline); join() raises it
        self.error: Optional[str] = None
        # the rendezvous trace: the accept loop runs under this context
        # (its connect/assign/barrier spans parent to the root span below),
        # and worker_envs() exports it as DMLC_TRACKER_TRACEPARENT so every
        # launched worker's spans join the same trace from its side of the
        # wire — one assembled timeline for the whole cold start
        self.trace = tracecontext.TraceContext(tracecontext.new_trace_id(),
                                               tracecontext.new_span_id())
        self._constructed_at = clock.monotonic()
        # the port is bound LAST: a constructor failure after the bind
        # would orphan the listening socket (the caller never receives the
        # instance, so the accept loop's own close can never run)
        self.sock, self.port = bind_free_port(host_ip, port, port_end)
        try:
            self.sock.listen(256)
        except BaseException:
            self.sock.close()
            raise
        logger.info("start listening on %s:%d", host_ip, self.port)

    # -- topology (tracker.py:165-252) ---------------------------------------
    @staticmethod
    def _tree_neighbors(rank: int, n: int) -> List[int]:
        rank = rank + 1
        out = []
        if rank > 1:
            out.append(rank // 2 - 1)
        if rank * 2 - 1 < n:
            out.append(rank * 2 - 1)
        if rank * 2 < n:
            out.append(rank * 2)
        return out

    @classmethod
    def get_tree(cls, n: int):
        tree_map = {r: cls._tree_neighbors(r, n) for r in range(n)}
        parent_map = {r: (r + 1) // 2 - 1 for r in range(n)}
        return tree_map, parent_map

    @classmethod
    def _share_ring_order(cls, tree_map, parent_map, r: int) -> List[int]:
        """DFS order that keeps ring hops close to tree links (used to recover
        local data, reference tracker.py:193-214)."""
        children = set(tree_map[r]) - {parent_map[r]}
        if not children:
            return [r]
        out = [r]
        for i, v in enumerate(sorted(children)):
            sub = cls._share_ring_order(tree_map, parent_map, v)
            if i == len(children) - 1:
                sub.reverse()
            out += sub
        return out

    @classmethod
    def get_ring(cls, tree_map, parent_map):
        order = cls._share_ring_order(tree_map, parent_map, 0)
        assert len(order) == len(tree_map)
        n = len(tree_map)
        ring_map = {}
        for i in range(n):
            ring_map[order[i]] = (order[(i - 1) % n], order[(i + 1) % n])
        return ring_map

    @classmethod
    def get_link_map(cls, n: int):
        """Relabel ranks so ring order == rank order (tracker.py:227-252)."""
        tree_map, parent_map = cls.get_tree(n)
        ring_map = cls.get_ring(tree_map, parent_map)
        rmap = {0: 0}
        k = 0
        for i in range(n - 1):
            k = ring_map[k][1]
            rmap[k] = i + 1
        ring_out = {rmap[k]: (rmap[v[0]], rmap[v[1]]) for k, v in ring_map.items()}
        tree_out = {rmap[k]: [rmap[x] for x in v] for k, v in tree_map.items()}
        parent_out = {rmap[k]: (rmap[v] if k != 0 else -1)
                      for k, v in parent_map.items()}
        return tree_out, parent_out, ring_out

    # -- env contract ---------------------------------------------------------
    def worker_envs(self) -> Dict[str, str]:
        return {"DMLC_TRACKER_URI": self.host_ip,
                "DMLC_TRACKER_PORT": str(self.port),
                tracecontext.TRACKER_TRACEPARENT_ENV:
                    tracecontext.format_traceparent(self.trace)}

    # -- accept loop (tracker.py:254-320) -------------------------------------
    def _reject(self, sock: socket.socket, reason: str, detail) -> None:
        """Reject one bad connection: log, count, close, carry on."""
        logger.warning("rejected connection (%s): %s", reason, detail)
        telemetry.count("dmlc_tracker_protocol_errors_total", reason=reason)
        try:
            sock.close()
        except OSError:
            pass

    def _fail_worker(self, worker: WorkerEntry, rank: int,
                     err: BaseException) -> None:
        """A worker died mid-rendezvous: fail THAT rank, keep the world."""
        msg = (f"rank {rank} ({worker.host}) failed during rendezvous: "
               f"{type(err).__name__}: {err}")
        logger.error("%s", msg)
        self.failed_ranks[rank] = msg
        telemetry.count("dmlc_tracker_worker_failures_total")
        try:
            worker.sock.sock.close()
        except OSError:
            pass

    def _assign(self, worker: WorkerEntry, rank: int, accept_registry,
                tree_map, parent_map, ring_map) -> bool:
        """assign_rank with per-worker exception isolation."""
        try:
            worker.assign_rank(rank, accept_registry, tree_map, parent_map,
                               ring_map)
        except (ProtocolError, OSError) as err:
            self._fail_worker(worker, rank, err)
            return False
        # a recovered rank is live again
        self.failed_ranks.pop(rank, None)
        return True

    def _accept_workers(self, n: int) -> None:
        try:
            # the loop thread runs under the rendezvous trace context, so
            # every span recorded inside (connect/assign/barrier) parents
            # to the tracker.rendezvous root span recorded below
            with tracecontext.activate(self.trace):
                self._accept_workers_inner(n)
        except Exception as exc:  # noqa: BLE001 — ferried to join()
            # the accept loop is the whole control plane: a crash here must
            # surface as a structured tracker error, never a silently dead
            # daemon thread with every worker blocked on it
            logger.exception("tracker accept loop died")
            self.error = (f"tracker accept loop died: "
                          f"{type(exc).__name__}: {exc}")
        finally:
            # recorded on EVERY exit path — clean finish, deadline expiry,
            # loop crash — as a child of the root span start() already
            # flushed (the loop may block forever when workers coordinate
            # via torch.distributed and never dial back; the root must not
            # depend on it exiting)
            telemetry.record_span(
                "tracker.rendezvous", self._constructed_at, clock.monotonic(),
                trace=(self.trace.trace_id, tracecontext.new_span_id(),
                       self.trace.span_id),
                world=n, error=self.error or "",
                failed_ranks=len(self.failed_ranks))
            # clean shutdown on every exit path: the port is freed and no
            # late client can block on a listener nobody serves
            try:
                self.sock.close()
            except OSError:
                pass

    def _accept_workers_inner(self, n: int) -> None:
        shutdown: Dict[int, WorkerEntry] = {}
        accept_registry: Dict[int, WorkerEntry] = {}
        jobid_ranks: Dict[str, int] = {}
        pending: List[WorkerEntry] = []
        tree_map = None
        todo_nodes: List[int] = []
        barrier_start: Optional[float] = None
        deadline_at: Optional[float] = None
        if self.rendezvous_deadline:
            # poll accept so the deadline fires even with nobody knocking
            self.sock.settimeout(0.1)
        # a rank that failed mid-rendezvous is terminal unless it recovers;
        # counting it lets the world finish instead of waiting forever for
        # a shutdown that will never come
        while len(set(shutdown) | set(self.failed_ranks)) < n:
            if deadline_at is not None and clock.monotonic() > deadline_at:
                self._rendezvous_expired(pending, todo_nodes, n)
                # the deadline exit must drop served shutdown connections
                # too, or their fds stay pinned exactly like the normal
                # exit used to leave them
                self._close_worker_socks(shutdown.values())
                return
            try:
                fd, addr = self.sock.accept()
            except socket.timeout:
                continue
            if deadline_at is None and self.rendezvous_deadline \
                    and tree_map is None:
                # armed by the first knock; disarmed once all ranks started
                deadline_at = clock.monotonic() + self.rendezvous_deadline
            # per-socket budget: the explicit sock_timeout, further clamped
            # to the remaining rendezvous deadline — without this a single
            # hung conversation would block the single-threaded loop PAST
            # the deadline it is supposed to enforce
            timeout = self.sock_timeout or None
            if deadline_at is not None:
                remaining = max(0.1, deadline_at - clock.monotonic())
                timeout = remaining if timeout is None \
                    else min(timeout, remaining)
            try:
                fault.inject("tracker.accept", host=addr[0])
                s = WorkerEntry(fd, addr, timeout=timeout)
            except (ProtocolError, OSError) as err:
                self._reject(fd, "handshake", err)
                continue
            if s.cmd == "print":
                try:
                    msg = s.sock.recvstr()
                except (ProtocolError, OSError) as err:
                    self._reject(fd, "print", err)
                    continue
                logger.info(msg.strip())
                try:
                    # one connection per print message: dropping the fd
                    # here used to park it on the GC (one leaked fd per
                    # print for the life of the rendezvous)
                    fd.close()
                except OSError:
                    pass
                continue
            if s.cmd == "shutdown":
                # rank must name a real slot: out-of-world shutdowns would
                # otherwise count toward loop termination and end the
                # rendezvous "cleanly" with the honest workers unserved
                if s.rank < 0 or s.rank >= n or s.rank in shutdown:
                    self._reject(fd, "shutdown",
                                 f"bad shutdown rank {s.rank} from {s.host} "
                                 f"(world {n})")
                    continue
                shutdown[s.rank] = s
                logger.debug("shutdown signal from %d", s.rank)
                continue
            if s.cmd not in ("start", "recover"):
                self._reject(fd, "bad-cmd",
                             f"unknown command {s.cmd!r} from {s.host}")
                continue
            if barrier_start is None:
                # barrier = first worker knocking until all n are started
                barrier_start = s.connect_span[0]
            if tree_map is None:
                if s.cmd != "start":
                    self._reject(fd, "recover-before-start",
                                 f"{s.cmd!r} from {s.host} before any "
                                 "worker started")
                    continue
                if s.world_size > MAX_PEERS:
                    # the announced world sizes topology dicts and the todo
                    # list: an unbounded value is a corrupt frame, not a
                    # big job — reject it before it allocates
                    self._reject(fd, "world-out-of-range",
                                 f"{s.host} announced world {s.world_size} "
                                 f"(max {MAX_PEERS})")
                    continue
                if s.world_size > 0:
                    n = s.world_size
                tree_map, parent_map, ring_map = self.get_link_map(n)
                todo_nodes = list(range(n))
            else:
                if s.world_size not in (-1, n):
                    self._reject(fd, "world-mismatch",
                                 f"{s.host} announced world {s.world_size}, "
                                 f"expected {n}")
                    continue
            if s.cmd == "recover" and s.rank < 0:
                self._reject(fd, "bad-recover-rank",
                             f"recover without a rank from {s.host}")
                continue
            if s.rank >= n:
                # a self-reported rank outside the world would index the
                # topology maps (KeyError) — reject the frame, keep the loop
                self._reject(fd, "rank-out-of-range",
                             f"{s.host} reported rank {s.rank} outside "
                             f"world {n}")
                continue
            rank = s.resolve_rank(jobid_ranks)
            if rank == -1:
                if not todo_nodes:
                    self._reject(fd, "extra-worker",
                                 f"no rank slots left for {s.host} "
                                 f"(world {n})")
                    continue
                pending.append(s)
                if len(pending) == len(todo_nodes):
                    pending.sort(key=lambda x: x.host)
                    for p in pending:
                        prank = todo_nodes.pop(0)
                        if p.jobid != "NULL":
                            jobid_ranks[p.jobid] = prank
                        if not self._assign(p, prank, accept_registry,
                                            tree_map, parent_map, ring_map):
                            continue
                        if p.pending_accepts > 0:
                            accept_registry[prank] = p
                        logger.debug("%s from %s; assigned rank %d",
                                     p.cmd, p.host, p.rank)
                    pending = []
                if not todo_nodes:
                    logger.info("@tracker all of %d nodes started", n)
                    self.start_time = time.time()
                    deadline_at = None  # rendezvous over; workers may run long
                    if barrier_start is not None:
                        telemetry.record_span("rendezvous.barrier",
                                              barrier_start, clock.monotonic(),
                                              world=n)
                        telemetry.observe("dmlc_rendezvous_barrier_seconds",
                                          clock.elapsed(barrier_start))
            else:
                if self._assign(s, rank, accept_registry, tree_map,
                                parent_map, ring_map):
                    logger.debug("%s signal from %d", s.cmd, s.rank)
                    if s.pending_accepts > 0:
                        accept_registry[rank] = s
        self.end_time = time.time()
        self._close_worker_socks(shutdown.values())
        logger.info("@tracker all nodes finished; %.3f secs between start and finish",
                    (self.end_time - (self.start_time or self.end_time)))

    @staticmethod
    def _close_worker_socks(entries) -> None:
        """Close served connections; they pin one fd per rank until the
        tracker object is collected otherwise."""
        for entry in entries:
            try:
                entry.sock.sock.close()
            except OSError:
                pass

    def _rendezvous_expired(self, pending: List[WorkerEntry],
                            todo_nodes: List[int], n: int) -> None:
        """Deadline hit mid-rendezvous: fail the stragglers, shut down clean.

        Every pending worker's socket is closed so its client observes a
        connection error (a structured failure on its side, within the
        deadline) instead of blocking forever on a tracker that gave up.
        """
        missing = len(todo_nodes) if todo_nodes else n
        self.error = (f"rendezvous deadline ({self.rendezvous_deadline:g}s) "
                      f"exceeded: {len(pending)} worker(s) pending, "
                      f"{missing} of {n} rank(s) never started")
        logger.error("%s", self.error)
        telemetry.count("dmlc_tracker_deadline_exceeded_total")
        self._close_worker_socks(pending)

    def start(self, num_workers: Optional[int] = None) -> None:
        n = num_workers if num_workers is not None else self.num_workers
        # the trace's root span is recorded HERE, not at loop exit: workers
        # that coordinate via the env contract + torch.distributed never dial
        # the rabit sockets, the accept loop then blocks until process
        # exit, and a root recorded only on loop exit would leave every
        # worker-side span (parented to it via DMLC_TRACKER_TRACEPARENT)
        # an orphan in the assembled trace
        telemetry.record_span(
            "tracker.start", self._constructed_at, clock.monotonic(),
            trace=(self.trace.trace_id, self.trace.span_id, None),
            world=n, host=self.host_ip, port=self.port)
        self.thread = threading.Thread(target=self._accept_workers, args=(n,),
                                       daemon=True)
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.time() + timeout
        while self.thread.is_alive():
            self.thread.join(0.1)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError("tracker did not finish in time")
        if self.error:
            raise TrackerError(self.error)
        if self.failed_ranks:
            detail = "; ".join(self.failed_ranks[r]
                               for r in sorted(self.failed_ranks))
            raise TrackerError(
                f"rendezvous completed with {len(self.failed_ranks)} failed "
                f"rank(s): {detail}")

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


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
        # same trace discipline as RabitTracker: worker_envs() exports this
        # so every worker's ingest.lease/ingest.unit spans join one timeline
        self.trace = tracecontext.TraceContext(tracecontext.new_trace_id(),
                                               tracecontext.new_span_id())
        self._constructed_at = clock.monotonic()
        n_units = len(self._units)
        # bound LAST (the RabitTracker discipline): a constructor failure
        # after the bind would orphan the listening socket
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


class PSTracker:
    """Parameter-server scheduler bootstrap (reference PSTracker,
    tracker.py:336-386): starts the ps-lite scheduler process locally and
    exports the DMLC_PS_ROOT env contract."""

    def __init__(self, host_ip: str, cmd: Optional[str], port: int = 9091,
                 port_end: int = 9999, envs: Optional[dict] = None):
        self.host_ip = host_ip
        self.cmd = cmd
        self._error: Optional[BaseException] = None
        if cmd:
            sock, self.port = bind_free_port(host_ip, port, port_end)
            sock.close()  # scheduler process rebinds it
            env = dict(os.environ)
            env.update({k: str(v) for k, v in (envs or {}).items()})
            env["DMLC_ROLE"] = "scheduler"
            env["DMLC_PS_ROOT_URI"] = str(host_ip)
            env["DMLC_PS_ROOT_PORT"] = str(self.port)

            def _run_scheduler() -> None:
                try:
                    subprocess.check_call(cmd, shell=True, env=env)
                except BaseException as exc:  # noqa: BLE001 - ferried to join
                    logger.error("ps scheduler failed: %s", exc)
                    self._error = exc

            self.thread = threading.Thread(target=_run_scheduler, daemon=True)
            self.thread.start()
        else:
            self.port = None
            self.thread = None

    def worker_envs(self) -> Dict[str, str]:
        if self.cmd:
            return {"DMLC_PS_ROOT_URI": self.host_ip,
                    "DMLC_PS_ROOT_PORT": str(self.port)}
        return {}

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"ps-lite scheduler {self.cmd!r} failed") from err
