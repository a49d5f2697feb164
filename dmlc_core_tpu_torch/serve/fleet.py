"""Replica fleet supervision: launch, watch, restart N scoring processes.

Counterpart of ``dmlc_core_tpu/serve/fleet.py``.
:class:`ReplicaFleet` owns the *process* half of the multi-replica tier:
it launches N ``python -m dmlc_core_tpu_torch.serve`` replicas, each on
``device`` (``cuda`` unless the caller passes ``device="cpu"``; on one
card every replica holds its own CUDA context), on **fixed ports**
(allocated once, below the kernel's ephemeral range, reused across
restarts — the router's replica URLs stay stable while processes come and
go), waits for ``/healthz`` readiness,
and optionally supervises them: a replica that exits (the SIGKILL chaos
drill) is relaunched on its own port and re-enters rotation through the
router's half-open recovery.

Rolling restart = :meth:`ReplicaFleet.rolling_restart`: one replica at a
time, SIGTERM (the replica drains: finishes in-flight requests, answers
``/healthz`` with ``draining``, exits cleanly), relaunch, wait healthy,
move on.  Under an open-loop load storm this must record **zero**
``crashed`` client samples.

The fleet inherits the parent environment (so ``DMLC_TELEMETRY_DIR`` and
``DMLC_FAULT_PLAN`` flow through to replicas) and prepends the repo root
to ``PYTHONPATH``.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from dmlc_core_tpu_torch.telemetry import clock
from dmlc_core_tpu_torch.utils.logging import log_debug, log_info, log_warning

__all__ = ["ReplicaFleet"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# the lowest port a fleet takes when it picks its own
_FIXED_PORT_FLOOR = 10000
_handed_out: set = set()        # ports this process has handed to fleets
_handed_out_lock = threading.Lock()


def _ephemeral_floor() -> Optional[int]:
    """The first port of the kernel's ephemeral range, where it knows."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def _bindable(host: str, port: int) -> bool:
    sock = socket.socket()
    try:
        sock.bind((host, port))
        return True
    except OSError:
        return False
    finally:
        sock.close()


def _free_port(host: str) -> int:
    """A port free right now, below the kernel's ephemeral range.

    A replica's port stays fixed across restarts, so it lies unbound
    between a replica's exit and its relaunch.  Inside the ephemeral
    range, an outgoing connection made in that gap (the router's probes
    and forwards to the dead port, on a busy host) can take it as its
    local port, or connect to itself there, and the relaunched replica
    then fails to bind.  Below the range no outgoing connection is given
    it.  Where the range is unknown, the kernel picks."""
    floor = _ephemeral_floor()
    if floor is not None and floor > _FIXED_PORT_FLOOR + 1000:
        rng = random.SystemRandom()
        for _ in range(200):
            port = rng.randrange(_FIXED_PORT_FLOOR, floor)
            with _handed_out_lock:
                if port in _handed_out or not _bindable(host, port):
                    continue
                _handed_out.add(port)
            return port
    sock = socket.socket()
    try:
        sock.bind((host, 0))
        return sock.getsockname()[1]
    finally:
        sock.close()


def _probe_healthz(host: str, port: int,
                   timeout_s: float = 1.0) -> Optional[Dict[str, Any]]:
    """Parsed /healthz JSON, or None on any failure."""
    conn: Optional[http.client.HTTPConnection] = None
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            return None
        parsed = json.loads(raw)
        return parsed if isinstance(parsed, dict) else None
    except (OSError, http.client.HTTPException, ValueError):
        return None
    finally:
        if conn is not None:
            conn.close()


class ReplicaFleet:
    """N supervised scoring replicas on fixed ports.

    ``per_replica_env``/``per_replica_args`` key on the replica index —
    how the chaos drill makes exactly one replica a straggler (its own
    ``DMLC_FAULT_PLAN``) without touching the others.  ``log_dir=None``
    sends replica output to the void; the drills always pass a directory
    so a failed gate has logs to read.
    """

    def __init__(self, count: int, *, model: str = "linear",
                 num_feature: int = 28, seed: int = 0,
                 host: str = "127.0.0.1",
                 ports: Optional[List[int]] = None,
                 max_batch: int = 64, max_delay_ms: float = 2.0,
                 max_queue_bytes: Optional[int] = None,
                 request_timeout_s: float = 10.0,
                 checkpoint: Optional[str] = None,
                 model_name: Optional[str] = None,
                 warmup: bool = True,
                 extra_args: Optional[List[str]] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 per_replica_env: Optional[Dict[int, Dict[str, str]]] = None,
                 per_replica_args: Optional[Dict[int, List[str]]] = None,
                 log_dir: Optional[str] = None,
                 auto_restart: bool = True,
                 device: str = "cuda"):
        if count < 1:
            raise ValueError(f"fleet needs at least 1 replica, got {count}")
        self.count = int(count)
        self.host = host
        if ports is not None:
            if len(ports) != count:
                raise ValueError(f"got {len(ports)} ports for {count} "
                                 "replicas")
            self.ports = [int(p) for p in ports]
        else:
            self.ports = [_free_port(host) for _ in range(count)]
        if len(set(self.ports)) != count:
            raise ValueError(f"duplicate replica ports {self.ports}")
        self.model = model
        self.num_feature = int(num_feature)
        self.seed = int(seed)
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.max_queue_bytes = max_queue_bytes
        self.request_timeout_s = float(request_timeout_s)
        self.checkpoint = checkpoint
        self.model_name = model_name
        self.warmup = warmup
        self.extra_args = list(extra_args or [])
        self.extra_env = dict(extra_env or {})
        self.per_replica_env = {int(k): dict(v) for k, v
                                in (per_replica_env or {}).items()}
        self.per_replica_args = {int(k): list(v) for k, v
                                 in (per_replica_args or {}).items()}
        self.log_dir = log_dir
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
        self.auto_restart = bool(auto_restart)
        self.device = str(device)
        self._lock = threading.Lock()
        self._procs: List[Optional[subprocess.Popen]] = [None] * count
        self._launches = [0] * count   # per-slot process incarnations
        self._paused = [False] * count  # monitor hands off (restart path)
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # -- addressing -----------------------------------------------------------

    def url(self, i: int) -> str:
        return f"http://{self.host}:{self.ports[i]}"

    @property
    def urls(self) -> List[str]:
        return [self.url(i) for i in range(self.count)]

    # -- launch / lifecycle ---------------------------------------------------

    def _argv(self, i: int) -> List[str]:
        argv = [sys.executable, "-m", "dmlc_core_tpu_torch.serve",
                "--model", self.model, "--device", self.device,
                "--num-feature", str(self.num_feature),
                "--seed", str(self.seed),
                "--host", self.host, "--port", str(self.ports[i]),
                "--max-batch", str(self.max_batch),
                "--max-delay-ms", str(self.max_delay_ms),
                "--request-timeout-s", str(self.request_timeout_s)]
        if self.max_queue_bytes is not None:
            argv += ["--max-queue-bytes", str(self.max_queue_bytes)]
        if self.checkpoint:
            argv += ["--checkpoint", self.checkpoint]
        if self.model_name:
            argv += ["--model-name", self.model_name]
        if not self.warmup:
            argv.append("--no-warmup")
        argv += self.extra_args
        argv += self.per_replica_args.get(i, [])
        return argv

    def _launch(self, i: int) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep \
            + env.get("PYTHONPATH", "")
        env.update(self.extra_env)
        env.update(self.per_replica_env.get(i, {}))
        if self.log_dir:
            # the child dups the descriptor at spawn; ours closes on exit
            with open(os.path.join(self.log_dir, f"replica-{i}.log"),
                      "ab") as log_fh:
                proc = subprocess.Popen(
                    self._argv(i), env=env,
                    stdout=log_fh, stderr=subprocess.STDOUT)
        else:
            proc = subprocess.Popen(
                self._argv(i), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        with self._lock:
            self._procs[i] = proc
            self._launches[i] += 1
            incarnation = self._launches[i]
        log_info(f"fleet: replica {i} (incarnation {incarnation}) pid "
                 f"{proc.pid} on {self.url(i)}")

    def start(self, wait_healthy: bool = True,
              timeout_s: float = 90.0) -> "ReplicaFleet":
        for i in range(self.count):
            self._launch(i)
        if wait_healthy:
            self.wait_healthy(timeout_s=timeout_s)
        if self.auto_restart:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor",
                daemon=True)
            self._monitor.start()
        return self

    def wait_healthy(self, indices: Optional[List[int]] = None,
                     timeout_s: float = 90.0) -> None:
        """Block until every (listed) replica answers /healthz "ok"."""
        pending = set(indices if indices is not None
                      else range(self.count))
        deadline = clock.monotonic() + timeout_s
        while pending:
            for i in sorted(pending):
                payload = _probe_healthz(self.host, self.ports[i])
                if payload is not None and payload.get("status") == "ok":
                    pending.discard(i)
            if not pending:
                return
            if clock.monotonic() >= deadline:
                raise RuntimeError(
                    f"replicas {sorted(pending)} not healthy after "
                    f"{timeout_s:g}s (ports "
                    f"{[self.ports[i] for i in sorted(pending)]})")
            time.sleep(0.1)

    def _monitor_loop(self) -> None:
        """Relaunch any replica whose process exits (unless its slot is
        paused for a supervised restart, or the fleet is closing)."""
        try:
            while not self._stop.is_set():
                for i in range(self.count):
                    with self._lock:
                        proc = self._procs[i]
                        paused = self._paused[i]
                    if proc is None or paused:
                        continue
                    code = proc.poll()
                    if code is None or self._stop.is_set():
                        continue
                    log_warning(f"fleet: replica {i} (pid {proc.pid}) "
                                f"exited rc={code}; relaunching")
                    self._launch(i)
                self._stop.wait(0.2)
        except Exception as exc:  # noqa: BLE001 — ferried, not swallowed
            log_warning(f"fleet: monitor exited abnormally: {exc!r}")

    def _set_paused(self, i: int, paused: bool) -> None:
        with self._lock:
            self._paused[i] = paused

    # -- chaos + restart surface ----------------------------------------------

    def pid(self, i: int) -> Optional[int]:
        with self._lock:
            proc = self._procs[i]
        return proc.pid if proc is not None else None

    def launches(self) -> List[int]:
        with self._lock:
            return list(self._launches)

    def kill(self, i: int) -> None:
        """SIGKILL replica ``i`` (the crash drill).  With auto_restart the
        monitor notices within ~200ms and relaunches on the same port."""
        with self._lock:
            proc = self._procs[i]
        if proc is not None and proc.poll() is None:
            log_info(f"fleet: SIGKILL replica {i} (pid {proc.pid})")
            proc.kill()

    def terminate(self, i: int, wait_s: float = 30.0) -> Optional[int]:
        """SIGTERM replica ``i`` and wait for its drain-and-exit.

        Pauses the monitor for the slot first (a drain is not a crash);
        the caller unpauses by relaunching via :meth:`restart` or
        resumes supervision itself.  Escalates to SIGKILL only if the
        drain deadline passes.
        """
        self._set_paused(i, True)
        with self._lock:
            proc = self._procs[i]
        if proc is None or proc.poll() is not None:
            return proc.poll() if proc is not None else None
        log_info(f"fleet: SIGTERM replica {i} (pid {proc.pid}) — draining")
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            log_warning(f"fleet: replica {i} did not drain within "
                        f"{wait_s:g}s; killing")
            proc.kill()
            try:
                return proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                return None

    def restart(self, i: int, wait_healthy: bool = True,
                timeout_s: float = 90.0) -> None:
        """Graceful single-replica restart: drain, relaunch, wait ready."""
        self.terminate(i)
        self._launch(i)
        if wait_healthy:
            self.wait_healthy([i], timeout_s=timeout_s)
        self._set_paused(i, False)

    def rolling_restart(self, settle_s: float = 0.5,
                        timeout_s: float = 90.0) -> None:
        """Restart every replica, one at a time, waiting for each to come
        back healthy (plus ``settle_s`` for the router's prober to
        re-admit it) before touching the next — at most one replica is
        ever out of rotation."""
        for i in range(self.count):
            log_info(f"fleet: rolling restart {i + 1}/{self.count}")
            self.restart(i, wait_healthy=True, timeout_s=timeout_s)
            time.sleep(settle_s)

    def poll(self) -> List[Optional[int]]:
        """Exit codes (None = running) without blocking."""
        out: List[Optional[int]] = []
        with self._lock:
            procs = list(self._procs)
        for proc in procs:
            out.append(None if proc is None else proc.poll())
        return out

    def close(self) -> None:
        """Stop supervision, drain every replica, reap everything."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(5.0)
            self._monitor = None
        with self._lock:
            procs = list(self._procs)
            for i in range(self.count):
                self._paused[i] = True
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = clock.monotonic() + 30.0
        for proc in procs:
            if proc is None:
                continue
            remaining = max(deadline - clock.monotonic(), 0.1)
            try:
                proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                log_warning(f"fleet: pid {proc.pid} ignored SIGTERM; "
                            "killing")
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    log_warning(f"fleet: pid {proc.pid} unreapable")
        log_debug(1, "fleet: closed")

    def __enter__(self) -> "ReplicaFleet":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.close()
