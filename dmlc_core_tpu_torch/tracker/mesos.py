"""Mesos backend: per-task launch on an Apache Mesos cluster.

Reference: tracker/dmlc_tracker/mesos.py — one Mesos task per worker/server
with ``cpus``/``mem`` resources, launched either through pymesos (when
importable) or by shelling out to ``mesos-execute`` against
``MESOS_MASTER``.  Env forwarded per task: the tracker contract plus
``DMLC_TASK_ID``/``DMLC_ROLE``, ``DMLC_SERVER_ID``/``DMLC_WORKER_ID`` and a
small passthrough whitelist (OMP_NUM_THREADS, KMP_AFFINITY,
LD_LIBRARY_PATH).

Counterpart of ``dmlc_core_tpu/tracker/mesos.py`` (a copy).
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import subprocess
import threading
import uuid
from typing import Dict, List

from dmlc_core_tpu_torch.tracker.submit import submit_job

__all__ = ["submit"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

# env vars forwarded from the submitting shell into every task
_FORWARD_ENV = ("OMP_NUM_THREADS", "KMP_AFFINITY", "LD_LIBRARY_PATH")


def _forwarded_env() -> Dict[str, str]:
    return {k: os.environ[k] for k in _FORWARD_ENV if k in os.environ}


def _resolve_master(opts) -> str:
    master = getattr(opts, "mesos_master", None) or os.environ.get("MESOS_MASTER")
    if not master:
        raise RuntimeError(
            "no Mesos master configured: set MESOS_MASTER or --mesos-master")
    if ":" not in master:
        master += ":5050"
    return master


def _try_pymesos_run(master: str, prog: str, env: Dict[str, str],
                     resources: Dict[str, float]) -> bool:
    """Run through pymesos when available; returns False to fall back."""
    try:
        import pymesos.subprocess  # type: ignore
    except ImportError:
        return False
    logging.getLogger("pymesos").setLevel(logging.WARNING)
    # pymesos reads the master from the env; hand it the resolved address so
    # --mesos-master and the :5050 default take effect on this path too
    os.environ["MESOS_MASTER"] = master
    pymesos.subprocess.check_call(
        prog, shell=True, env=env, cwd=os.getcwd(),
        cpus=resources["cpus"], mem=resources["mem"])
    return True


def _mesos_execute_argv(master: str, prog: str, env: Dict[str, str],
                        resources: Dict[str, float]) -> List[str]:
    """Build the ``mesos-execute`` command line for one task."""
    res = ";".join(f"{k}:{v}" for k, v in sorted(resources.items()))
    return [
        "mesos-execute",
        f"--master={master}",
        f"--name=dmlc-{uuid.uuid4()}",
        f"--command=cd {shlex.quote(os.getcwd())} && {prog}",
        f"--env={json.dumps(env)}",
        f"--resources={res}",
    ]


def _run_task(master: str, prog: str, env: Dict[str, str],
              resources: Dict[str, float]) -> None:
    if _try_pymesos_run(master, prog, env, resources):
        return
    argv = _mesos_execute_argv(master, prog, env, resources)
    proc = subprocess.run(argv, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        logger.error("mesos-execute failed (exit %d) for task %s:\n%s",
                     proc.returncode, env.get("DMLC_TASK_ID", "?"),
                     proc.stdout)
        raise RuntimeError(
            f"mesos-execute exited {proc.returncode} for task "
            f"{env.get('DMLC_TASK_ID', '?')}")


def submit(opts) -> None:
    master = _resolve_master(opts)

    # file shipping: wrap the task in the launcher, which materializes
    # DMLC_JOB_FILES / unpacks DMLC_JOB_ARCHIVES into the task cwd
    # (sources must be agent-visible, e.g. shared FS).  always=True:
    # containers get a fresh sandbox, so auto-file-cache applies without
    # explicit --files, like the reference's YARN semantics.
    from dmlc_core_tpu_torch.tracker.filecache import prepare_shipping

    ship_env, command, _, _ = prepare_shipping(opts, wrap_launcher=True,
                                               always=True)

    def fun_submit(envs: Dict[str, str]) -> None:
        envs = {**envs, **ship_env}
        prog = " ".join(command)
        threads = []
        errors: List[BaseException] = []

        def run(env: Dict[str, str], resources: Dict[str, float]) -> None:
            try:
                _run_task(master, prog, env, resources)
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

        for i in range(opts.num_servers + opts.num_workers):
            env = dict(envs)
            # task ids are role-relative (workers 0..nw-1): DMLC_TASK_ID is
            # the collective's process id, same split as ssh.py/sge.py
            if i < opts.num_servers:
                env["DMLC_ROLE"] = "server"
                env["DMLC_TASK_ID"] = str(i)
                env["DMLC_SERVER_ID"] = str(i)
                resources = {"cpus": float(opts.server_cores),
                             "mem": float(opts.server_memory_mb)}
            else:
                env["DMLC_ROLE"] = "worker"
                env["DMLC_TASK_ID"] = str(i - opts.num_servers)
                env["DMLC_WORKER_ID"] = str(i - opts.num_servers)
                resources = {"cpus": float(opts.worker_cores),
                             "mem": float(opts.worker_memory_mb)}
            for k, v in _forwarded_env().items():
                env.setdefault(k, v)
            env = {str(k): str(v) for k, v in env.items()}
            t = threading.Thread(target=run, args=(env, resources),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    submit_job(opts, fun_submit, wait=False)
