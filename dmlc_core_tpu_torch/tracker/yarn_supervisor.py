"""Container supervision: the YARN ApplicationMaster's retry/blacklist brain.

The reference supervises its own containers from a 687-LoC Java
ApplicationMaster: each task retries up to ``maxNumAttempt`` (default 3,
``DMLC_MAX_ATTEMPT``; ApplicationMaster.java:74,210), a failing container's
node goes onto a blacklist (ApplicationMaster.java:112,554) so later
allocations on that node are burned with a dummy task instead of a real one
(ApplicationMaster.java:486-488), memory-limit kills abort the whole job
(ApplicationMaster.java:585-600), and exhausting attempts aborts with the
task named (ApplicationMaster.java:558-561).

This module is that state machine, extracted from the YARN callback plumbing
so it is (a) unit-testable against a fake cluster and (b) reusable by any
launcher that can report "container started on node N" / "container finished
with status S" — the TPU-VM and local backends see the same failure shapes.
The YARN REST wiring lives in :mod:`.yarn`.

Counterpart of ``dmlc_core_tpu/tracker/yarn_supervisor.py`` (a copy).

Event protocol (mirrors the AMRMClientAsync callbacks):

- :meth:`ContainerSupervisor.start` queues every task as pending and asks the
  cluster for containers (submitTasks, ApplicationMaster.java:308-324).
- :meth:`on_containers_allocated` — for each offered container: blacklisted
  node -> ``cluster.burn`` (the dummy-task move), no pending work ->
  ``cluster.release``, else ``cluster.launch`` (onContainersAllocated,
  ApplicationMaster.java:478-500).
- :meth:`on_container_completed` — SUCCESS finishes the task; memory-kill
  statuses abort the job; any other failure bumps the attempt counter,
  blacklists the node, and resubmits (onContainersCompleted + handleFailure,
  ApplicationMaster.java:535-613).
- :meth:`on_container_error` — NM-side launch error: same failure path
  (onStartContainerError, ApplicationMaster.java:655-673).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from dmlc_core_tpu_torch.param import get_env

__all__ = ["Container", "TaskRecord", "ClusterBackend", "JobAbort",
           "ContainerSupervisor", "EXIT_SUCCESS", "EXIT_KILLED_PMEM",
           "EXIT_KILLED_VMEM"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

# YARN ContainerExitStatus values the AM special-cases
EXIT_SUCCESS = 0
EXIT_KILLED_PMEM = -104   # KILLED_EXCEEDED_PMEM
EXIT_KILLED_VMEM = -103   # KILLED_EXCEEDED_VMEM


@dataclass(frozen=True)
class Container:
    """An allocated container: identity + the node it landed on.

    ``task_id`` is set by backends whose containers are pre-bound to a task
    (the REST adapter bakes DMLC_TASK_ID into each app's command at submit
    time); the supervisor then matches the exact task instead of FIFO-popping
    pending work — out-of-order RUNNING reports must not misattribute tasks.
    YARN-AM-style backends where any container serves any task leave it None.
    """

    container_id: str
    node: str
    task_id: Optional[int] = None


@dataclass
class TaskRecord:
    """Reference TaskRecord.java: task identity + attempt bookkeeping."""

    task_id: int
    role: str = "worker"
    attempts: int = 0
    container: Optional[Container] = None


class ClusterBackend:
    """What the supervisor needs from a cluster (the RM/NM client surface).

    Implementations: the REST adapter in :mod:`.yarn`, fakes in tests.
    """

    def request_containers(self, tasks: List[TaskRecord]) -> None:
        """Ask for one container per task (rmClient.addContainerRequest)."""
        raise NotImplementedError

    def launch(self, container: Container, task: TaskRecord) -> None:
        """Start the task's command in the container (nmClient.startContainerAsync)."""
        raise NotImplementedError

    def burn(self, container: Container) -> None:
        """Launch a no-op in a container on a blacklisted node.

        The reference cannot return a tainted container without the RM
        re-offering it, so it runs ``./launcher.py`` with no command — a
        dummy task (launchDummyTask, ApplicationMaster.java:329-345).
        """
        raise NotImplementedError

    def release(self, container: Container) -> None:
        """Free a surplus container (freeUnusedContainers)."""
        raise NotImplementedError

    def stop(self, container: Container) -> None:
        """Stop a failed container (nmClient.stopContainerAsync)."""
        raise NotImplementedError

    def cancel_requests(self, tasks: List[TaskRecord]) -> None:
        """Withdraw outstanding container requests on abort.

        REST-model backends have a live application per pending task; leaving
        them running after a JobAbort would leak cluster resources.  Default
        no-op matches the reference AM (the RM reclaims open requests when
        the AM unregisters).
        """


class JobAbort(RuntimeError):
    """Raised when the job must die (abortJob, ApplicationMaster.java:616)."""


class ContainerSupervisor:
    """Per-task retry + node blacklist over a :class:`ClusterBackend`.

    Single-threaded by design: callers serialize events into it (the
    reference reaches the same effect by making every callback
    ``synchronized``).
    """

    def __init__(self, cluster: ClusterBackend, num_workers: int,
                 num_servers: int = 0, max_attempts: Optional[int] = None):
        if max_attempts is None:
            # reference: DMLC_MAX_ATTEMPT env, default 3
            max_attempts = get_env("DMLC_MAX_ATTEMPT", int, 3)
        self.cluster = cluster
        self.max_attempts = max_attempts
        self.tasks = ([TaskRecord(i, "worker") for i in range(num_workers)]
                      + [TaskRecord(num_workers + i, "server")
                         for i in range(num_servers)])
        self.pending: List[TaskRecord] = []
        self.running: Dict[str, TaskRecord] = {}
        self.finished: List[TaskRecord] = []
        self.killed: List[TaskRecord] = []
        self.blacklist: Set[str] = set()
        self.aborted: Optional[str] = None   # diagnosis once aborting

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._submit(list(self.tasks))

    @property
    def done(self) -> bool:
        return (self.aborted is None and not self.pending and not self.running
                and len(self.finished) == len(self.tasks))

    # -- event handlers ------------------------------------------------------
    def on_containers_allocated(self, containers: List[Container]) -> None:
        if self.aborted is not None:
            for c in containers:
                self.cluster.release(c)
            return
        for c in containers:
            if c.node in self.blacklist:
                logger.info("container %s on blacklisted node %s: burning",
                            c.container_id, c.node)
                self.cluster.burn(c)
                continue
            task = self._match_pending(c)
            if task is None:
                self.cluster.release(c)
                continue
            task.container = c
            self.running[c.container_id] = task
            self.cluster.launch(c, task)

    def on_container_completed(self, container_id: str, exit_status: int,
                               diagnostics: str = "") -> None:
        task = self.running.get(container_id)
        if task is None:
            return
        if exit_status == EXIT_SUCCESS:
            del self.running[container_id]
            task.container = None
            self.finished.append(task)
            return
        if exit_status in (EXIT_KILLED_PMEM, EXIT_KILLED_VMEM):
            kind = "physical" if exit_status == EXIT_KILLED_PMEM else "virtual"
            self._abort(f"[DMLC] Task {task.task_id} killed because of "
                        f"exceeding allocated {kind} memory")
            return
        logger.info("[DMLC] Task %d exited with status %d Diagnostics: %s",
                    task.task_id, exit_status, diagnostics)
        self._handle_failure(container_id)

    def on_container_error(self, container_id: str, error: str) -> None:
        """NM could not start / lost the container: treated as a failure."""
        logger.warning("container %s error: %s", container_id, error)
        self._handle_failure(container_id)

    def on_unreported_completion(self, c: Container, exit_status: int,
                                 diagnostics: str = "") -> None:
        """Terminal event for a container that never reported a placement.

        REST-model backends can see an app jump straight to FAILED/FINISHED
        between polls (fast-failing command, queue rejection).  Routing that
        through the allocation path would be wrong — a blacklisted node would
        burn the already-dead container and swallow the completion — so the
        task is matched and completed directly: successes count, failures
        bump the attempt counter like any other.
        """
        task = self._match_pending(c)
        if task is None:
            return
        task.container = c
        self.running[c.container_id] = task
        self.on_container_completed(c.container_id, exit_status, diagnostics)

    # -- internals -----------------------------------------------------------
    def _match_pending(self, c: Container) -> Optional[TaskRecord]:
        """The pending task this container serves: the pre-bound one when the
        container names a task, else the head of the queue."""
        if c.task_id is None:
            return self.pending.pop(0) if self.pending else None
        for i, task in enumerate(self.pending):
            if task.task_id == c.task_id:
                return self.pending.pop(i)
        return None

    def _submit(self, tasks: List[TaskRecord]) -> None:
        self.pending.extend(tasks)
        self.cluster.request_containers(tasks)

    def _handle_failure(self, container_id: str) -> None:
        task = self.running.pop(container_id, None)
        if task is None:
            return
        container = task.container
        task.attempts += 1
        task.container = None
        if container is not None:
            # stop the failed container and blacklist its node (containers
            # that died before ever reporting a placement have no node)
            self.cluster.stop(container)
            if container.node:
                self.blacklist.add(container.node)
            logger.info("task %d failed on %s (attempt %d/%d); node "
                        "blacklisted", task.task_id, container.node,
                        task.attempts, self.max_attempts)
        if task.attempts >= self.max_attempts:
            self.killed.append(task)
            self._abort(f"[DMLC] Task {task.task_id} failed more than "
                        f"{task.attempts} times")
            return
        if self.aborted is not None:
            self.killed.append(task)
            return
        self._submit([task])

    def _abort(self, diagnosis: str) -> None:
        if self.aborted is None:
            self.aborted = diagnosis
            logger.error("%s", diagnosis)
        # running containers are stopped; pending work (and any outstanding
        # container requests backing it) is withdrawn
        for cid, task in list(self.running.items()):
            if task.container is not None:
                self.cluster.stop(task.container)
            self.killed.append(task)
        self.running.clear()
        if self.pending:
            self.cluster.cancel_requests(list(self.pending))
            self.killed.extend(self.pending)
            self.pending.clear()
        raise JobAbort(diagnosis)
