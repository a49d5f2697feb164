"""YARN backend: per-task apps via the ResourceManager REST API, supervised.

The reference ships a 1k-LoC Java Client/ApplicationMaster pair
(tracker/yarn/, reference yarn.py:16-129) whose AM requests one container per
task, retries each task up to ``DMLC_MAX_ATTEMPT`` times, and blacklists
nodes that fail a container (ApplicationMaster.java:74,112,535-566).  The
rebuild keeps that *supervision capability* without the Java build:

- each task (worker/server) is submitted as its own YARN application whose
  AM container runs the task command through
  ``dmlc_core_tpu_torch.tracker.launcher`` — the REST API's unit of
  placement and monitoring is the application attempt, so "task
  container" maps to "the app's AM container";
- :class:`~.yarn_supervisor.ContainerSupervisor` (the extracted AM state
  machine) drives retry + blacklist decisions; this module is only the REST
  adapter: submit app = request container, app RUNNING on node N = container
  allocated on N, app FAILED = container failed, kill+resubmit = the
  dummy-task burn for placements on blacklisted nodes.

Config: ``YARN_RM_URI`` (e.g. http://rm-host:8088) or --env YARN_RM_URI=...;
resources from --worker-cores/--worker-memory (the reference's
DMLC_WORKER_CORES/MEMORY_MB contract, yarn.py:89-96).

Counterpart of ``dmlc_core_tpu/tracker/yarn.py`` (a copy; the container runs
the port's launcher module).
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Dict, List

from dmlc_core_tpu_torch.tracker.submit import submit_job
from dmlc_core_tpu_torch.tracker.yarn_supervisor import (
    EXIT_KILLED_PMEM, EXIT_KILLED_VMEM, ClusterBackend, Container,
    ContainerSupervisor, JobAbort, TaskRecord)
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["submit", "RestYarnCluster"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def _rest(rm_uri: str, path: str, payload: Dict = None, method: str = "GET"):
    url = rm_uri.rstrip("/") + path
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        body = resp.read()
        return resp.status, json.loads(body) if body else {}


def _exit_status_from_diag(diagnostics: str) -> int:
    """Map YARN diagnostics text to the AM's special-cased exit statuses.

    The REST app report carries no container exit code, but the NM's
    memory-kill diagnostics are stable strings ("... is running beyond
    physical/virtual memory limits ..."); the reference AM aborts the whole
    job on those (ApplicationMaster.java:585-600) instead of retrying a task
    that will just be killed again.
    """
    d = diagnostics.lower()
    if "beyond physical memory" in d:
        return EXIT_KILLED_PMEM
    if "beyond virtual memory" in d:
        return EXIT_KILLED_VMEM
    return -1


def _launch_command(opts, envs: Dict[str, str], task: TaskRecord) -> str:
    exports = " && ".join(
        f"export {k}='{v}'" for k, v in {**envs, "DMLC_ROLE": task.role,
                                         "DMLC_TASK_ID": str(task.task_id),
                                         "DMLC_NUM_ATTEMPT":
                                             str(task.attempts),
                                         "DMLC_JOB_CLUSTER": "yarn"}.items())
    from dmlc_core_tpu_torch.tracker.filecache import remote_python

    cmd = " ".join(opts.command)
    return (f"{exports} && {remote_python()} -m "
            f"dmlc_core_tpu_torch.tracker.launcher {cmd} "
            f"1><LOG_DIR>/stdout 2><LOG_DIR>/stderr")


class RestYarnCluster(ClusterBackend):
    """ClusterBackend over the RM REST API: one application per task."""

    def __init__(self, rm_uri: str, opts, envs: Dict[str, str]):
        self.rm_uri = rm_uri
        self.opts = opts
        self.envs = envs
        self.app_task: Dict[str, TaskRecord] = {}   # app_id -> task
        self.reported: Dict[str, str] = {}          # app_id -> node reported
        self.live: List[str] = []                   # app ids worth polling
        self.poll_errors: Dict[str, int] = {}       # app_id -> consecutive
        self.submit_backlog: List[TaskRecord] = []  # deferred (RM was down)

    # -- ClusterBackend ------------------------------------------------------
    def request_containers(self, tasks: List[TaskRecord]) -> None:
        for task in tasks:
            self._try_submit_app(task)

    def launch(self, container: Container, task: TaskRecord) -> None:
        # the app's AM container already runs the task command; allocation
        # and launch coincide in the REST model
        pass

    def burn(self, container: Container) -> None:
        # a placement on a blacklisted node cannot be re-targeted over REST:
        # kill the app and submit a replacement (the reference burns the
        # container with a dummy task instead, ApplicationMaster.java:486)
        task = self.app_task.get(container.container_id)
        self._kill_app(container.container_id)
        if task is not None:
            self._try_submit_app(task)

    def release(self, container: Container) -> None:
        self._kill_app(container.container_id)

    def stop(self, container: Container) -> None:
        self._kill_app(container.container_id)

    def cancel_requests(self, tasks: List[TaskRecord]) -> None:
        # every pending task is backed by a live application; kill them so an
        # aborted job does not leak cluster resources
        ids = {t.task_id for t in tasks}
        for app_id, task in list(self.app_task.items()):
            if task.task_id in ids and app_id in self.live:
                self._kill_app(app_id)

    # -- REST plumbing -------------------------------------------------------
    def _try_submit_app(self, task: TaskRecord) -> None:
        """Submit, deferring to the next poll sweep when the RM is down.

        A (re)submission raced against an RM outage must not crash the
        supervision loop — the task stays pending in the supervisor, and the
        backlog retries once per sweep until the RM answers.
        """
        try:
            self._submit_app(task)
        except (OSError, ValueError) as exc:
            # URLError/HTTPError are OSError subclasses; ValueError covers a
            # proxy/LB answering 200 with a non-JSON body mid-outage
            logger.warning("submit of task %d failed (%s); will retry",
                           task.task_id, exc)
            self.submit_backlog.append(task)

    def _submit_app(self, task: TaskRecord) -> None:
        status, new_app = _rest(self.rm_uri,
                                "/ws/v1/cluster/apps/new-application",
                                payload={}, method="POST")
        CHECK(status in (200, 201), f"new-application failed: {status}")
        app_id = new_app["application-id"]
        mem = (self.opts.server_memory_mb if task.role == "server"
               else self.opts.worker_memory_mb)
        cores = (self.opts.server_cores if task.role == "server"
                 else self.opts.worker_cores)
        payload = {
            "application-id": app_id,
            "application-name":
                f"{self.opts.jobname}[{task.task_id}]:{task.role}",
            "application-type": "DMLC",
            "queue": self.opts.queue,
            # per-task retry belongs to the supervisor; the RM must not also
            # retry behind its back
            "max-app-attempts": 1,
            "am-container-spec": {
                "commands": {"command":
                             _launch_command(self.opts, self.envs, task)},
                "environment": {"entry": [
                    {"key": k, "value": str(v)}
                    for k, v in self.envs.items()]},
            },
            "resource": {"memory": mem, "vCores": cores},
        }
        status, _ = _rest(self.rm_uri, "/ws/v1/cluster/apps", payload=payload,
                          method="POST")
        CHECK(status in (200, 202), f"application submit failed: {status}")
        self.app_task[app_id] = task
        self.live.append(app_id)
        logger.info("submitted task %d (%s) as %s", task.task_id, task.role,
                    app_id)

    def _kill_app(self, app_id: str) -> None:
        try:
            _rest(self.rm_uri, f"/ws/v1/cluster/apps/{app_id}/state",
                  payload={"state": "KILLED"}, method="PUT")
        except OSError as exc:      # already gone is fine
            logger.warning("kill %s failed: %s", app_id, exc)
        if app_id in self.live:
            self.live.remove(app_id)
        self.reported.pop(app_id, None)

    # -- polling -> supervisor events ---------------------------------------
    # consecutive poll errors before an app is declared lost (RM restarted
    # and forgot it, network partition to the RM, ...)
    MAX_POLL_ERRORS = 5

    def poll(self, sup: ContainerSupervisor) -> None:
        """One monitoring sweep: translate app states to supervisor events."""
        backlog, self.submit_backlog = self.submit_backlog, []
        for task in backlog:
            self._try_submit_app(task)
        for app_id in list(self.live):
            try:
                _, body = _rest(self.rm_uri, f"/ws/v1/cluster/apps/{app_id}")
            except (urllib.error.URLError, OSError, ValueError) as exc:
                # transient RM errors must not crash a long-lived supervision
                # loop; persistent ones mean the container is lost
                n = self.poll_errors.get(app_id, 0) + 1
                self.poll_errors[app_id] = n
                logger.warning("poll %s failed (%d/%d): %s", app_id, n,
                               self.MAX_POLL_ERRORS, exc)
                if n >= self.MAX_POLL_ERRORS:
                    self.live.remove(app_id)
                    msg = f"unpollable: {exc}"
                    if app_id in self.reported:
                        sup.on_container_error(app_id, msg)
                    else:
                        self.reported[app_id] = ""
                        sup.on_unreported_completion(
                            self._container(app_id, ""), -1, msg)
                continue
            self.poll_errors.pop(app_id, None)
            app = body.get("app", body)
            state = app.get("state", "")
            node = (app.get("amHostHttpAddress") or "").split(":")[0]
            terminal = state in ("FINISHED", "FAILED", "KILLED")
            if app_id not in self.reported and node and not terminal:
                # first placement report = the allocation event; the
                # supervisor may respond by burning (blacklisted node)
                self.reported[app_id] = node
                sup.on_containers_allocated(
                    [self._container(app_id, node)])
                continue
            if terminal:
                self.live.remove(app_id)
                final = app.get("finalStatus", "")
                ok = state == "FINISHED" and final == "SUCCEEDED"
                diag = app.get("diagnostics", "")
                status = 0 if ok else _exit_status_from_diag(diag)
                if app_id in self.reported:
                    sup.on_container_completed(app_id, status,
                                               diagnostics=diag)
                else:
                    # died (or finished) before ever reporting a node: no
                    # allocation happened, so route around the blacklist/burn
                    # logic and complete the task directly
                    self.reported[app_id] = node
                    sup.on_unreported_completion(
                        self._container(app_id, node), status, diag)

    def _container(self, app_id: str, node: str) -> Container:
        task = self.app_task[app_id]
        return Container(app_id, node, task_id=task.task_id)


def supervise(cluster: RestYarnCluster, num_workers: int, num_servers: int,
              poll_interval: float = 2.0, max_polls: int = 0) -> ContainerSupervisor:
    """Run the AM-equivalent supervision loop until the job finishes.

    Raises :class:`JobAbort` when a task exhausts its attempts or dies of a
    memory kill (the reference AM's unregister-with-FAILED path).
    """
    sup = ContainerSupervisor(cluster, num_workers, num_servers)
    sup.start()
    polls = 0
    while not sup.done:
        cluster.poll(sup)
        polls += 1
        if max_polls and polls >= max_polls:
            break
        if not sup.done:
            time.sleep(poll_interval)
    return sup


def submit(opts) -> None:
    rm_uri = os.environ.get("YARN_RM_URI", "")
    for kv in getattr(opts, "env", []):
        if kv.startswith("YARN_RM_URI="):
            rm_uri = kv.split("=", 1)[1]
    CHECK(rm_uri, "yarn backend needs YARN_RM_URI (ResourceManager REST "
                  "endpoint, e.g. http://rm:8088)")

    # file shipping: every task command already routes through the
    # container-side launcher, which materializes DMLC_JOB_FILES and
    # unpacks DMLC_JOB_ARCHIVES into the task cwd (sources must be
    # container-visible, e.g. shared FS — the REST adapter has no
    # HDFS-localized-resource path).  always=True: like the reference's
    # YARN backend, auto-file-cache applies without explicit --files.
    from dmlc_core_tpu_torch.tracker.filecache import prepare_shipping

    ship_env, opts.command, _, _ = prepare_shipping(opts, always=True)

    def fun_submit(envs: Dict[str, str]) -> None:
        cluster = RestYarnCluster(rm_uri, opts, {**envs, **ship_env})
        try:
            sup = supervise(cluster, opts.num_workers, opts.num_servers)
            logger.info("yarn job %s finished: %d tasks ok", opts.jobname,
                        len(sup.finished))
        except JobAbort as exc:
            logger.error("yarn job %s aborted: %s", opts.jobname, exc)
            raise

    submit_job(opts, fun_submit, wait=True)
