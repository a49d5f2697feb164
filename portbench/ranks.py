"""The ranks of a benchmark job that spans several processes.

The harness's own process is rank 0.  :class:`Job` starts ranks
``1 .. world-1`` as child interpreters of this file, each calling one
function (``"module:function"``) with one JSON argument, each with the
DMLC env contract that the port's tracker
launchers set (``DMLC_TASK_ID``, ``DMLC_NUM_WORKER``,
``DMLC_COORDINATOR_URI``/``PORT`` on a free local port, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), and returns the rank-0 env for
``collective.init``.  A child's standard output goes to the harness's
standard error, so the result stays the last line of standard output.

Failure never hangs a run.  A watchdog thread in rank 0 ends the whole
job (children first, then its own process, with exit code 1) as soon as a
child exits with another code than 0, and :meth:`Job.finish` gives the
children a deadline.  A child ends itself when rank 0 goes away.  Leaving
the ``with`` block kills whatever children remain.  Collectives time out
on their own (``collective.init({"timeout": s})``).
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return {"DMLC_TASK_ID": str(rank), "DMLC_NUM_WORKER": str(world),
            "DMLC_COORDINATOR_URI": "127.0.0.1",
            "DMLC_COORDINATOR_PORT": str(port),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


def child_command(rank: int, entry: str, args: Dict) -> List[str]:
    """The command that runs rank ``rank`` (a test may replace it)."""
    return [sys.executable, os.path.abspath(__file__),
            json.dumps({"entry": entry, "args": args})]


class Job:
    """Ranks ``1 .. world-1`` of a job, each calling ``entry``
    (``"module:function"``) with ``args``; ``env`` is rank 0's."""

    def __init__(self, entry: str, args: Dict, world: int):
        port = free_port()
        self.env = rank_env(0, world, port)
        self.children: List[subprocess.Popen] = []
        for rank in range(1, world):
            env = dict(os.environ, **rank_env(rank, world, port))
            self.children.append(subprocess.Popen(
                child_command(rank, entry, args), env=env, cwd=ROOT,
                stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno()))
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def _dead(self) -> List[str]:
        return [f"rank {rank} exited with code {p.returncode}"
                for rank, p in enumerate(self.children, 1)
                if p.poll() not in (None, 0)]

    def _watch(self) -> None:
        while not self._done.wait(0.2):
            dead = self._dead()
            if dead:
                print(f"portbench: {'; '.join(dead)}; ending the job",
                      file=sys.stderr, flush=True)
                self.kill()
                os._exit(1)

    def kill(self) -> None:
        for p in self.children:
            if p.poll() is None:
                p.kill()
        for p in self.children:
            p.wait()

    def finish(self, timeout: float) -> None:
        """Wait up to ``timeout`` seconds for every child to exit with code
        0; raise otherwise."""
        deadline = time.monotonic() + timeout
        for rank, p in enumerate(self.children, 1):
            try:
                rc = p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {rank} did not exit within "
                                   f"{timeout} s") from None
            if rc != 0:
                raise RuntimeError(f"rank {rank} exited with code {rc}")

    def __enter__(self) -> "Job":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self._done.set()
        if exc_type is not None:
            # rank 0's own error may be its peer's death (gloo raises
            # at once where NCCL waits): give a dying child a moment
            deadline = time.monotonic() + 2.0
            while not self._dead() and time.monotonic() < deadline:
                time.sleep(0.05)
            for line in self._dead():
                print(f"portbench: {line}", file=sys.stderr, flush=True)
        self.kill()


def _child(arg: str) -> int:
    """A child rank: the call its argument names, ended at once when its
    parent, rank 0, goes away."""
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    call = json.loads(arg)
    module, function = call["entry"].split(":")
    getattr(importlib.import_module(module), function)(call["args"])
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(_child(sys.argv[1]))
