"""Local backend: one subprocess per worker/server on this host.

Counterpart of ``dmlc_core_tpu/tracker/local.py``.

Reference: tracker/dmlc_tracker/local.py:12-72 — thread-per-process launch,
``DMLC_TASK_ID``/``DMLC_ROLE`` env, retry via ``DMLC_NUM_ATTEMPT``.
"""

from __future__ import annotations

import logging
import os
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import shutil

from dmlc_core_tpu_torch.tracker.filecache import prepare_shipping, stage_job_dir
from dmlc_core_tpu_torch.tracker.submit import submit_job

__all__ = ["submit", "exec_cmd"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def exec_cmd(cmd: List[str], role: str, taskid: int, pass_env: Dict[str, str],
             num_attempt: int = 1, cwd: Optional[str] = None) -> None:
    """Run one task with retry (reference local.py:25-40).

    ``num_attempt`` is the total attempt budget; like the reference, the
    ``DMLC_NUM_ATTEMPT`` env var is exported once (the configured budget)
    and never mutated across retries.  ``cwd`` is the staged job dir when
    the submit shipped files (the local stand-in for a container sandbox).
    """
    env = os.environ.copy()
    env.update(pass_env)
    env["DMLC_TASK_ID"] = str(taskid)
    env["DMLC_ROLE"] = role
    env["DMLC_NUM_ATTEMPT"] = str(num_attempt)
    num_retry = num_attempt
    while True:
        ret = subprocess.call(cmd, env=env, cwd=cwd)
        if ret == 0:
            logger.debug("task %s:%d finished", role, taskid)
            return
        num_retry -= 1
        if num_retry <= 0:
            raise RuntimeError(f"task {role}:{taskid} failed with exit {ret}")
        logger.warning("task %s:%d failed (exit %d); retrying", role, taskid, ret)


def submit(opts) -> None:
    # file shipping: only when the job names files/archives explicitly —
    # a bare local run keeps its cwd and command untouched (no surprise
    # directory changes for jobs that never opted into shipping)
    ship_env, command, files, archives = prepare_shipping(opts)
    job_dir = None
    if files or archives:
        job_dir = tempfile.mkdtemp(prefix="dmlc-job-")
        try:
            stage_job_dir(files, archives, job_dir)
        except BaseException:
            # staging failed before anything owns the dir: fun_submit's
            # finally (the normal cleanup path) never runs on this edge
            shutil.rmtree(job_dir, ignore_errors=True)
            raise
        ship_env["DMLC_JOB_CWD"] = job_dir
        logger.info("staged %d files / %d archives into %s",
                    len(files), len(archives), job_dir)

    def fun_submit(envs: Dict[str, str]) -> None:
        envs = {**envs, **ship_env}
        threads = []
        errors: List[BaseException] = []

        def run(role: str, taskid: int) -> None:
            try:
                exec_cmd(command, role, taskid, envs,
                         num_attempt=getattr(opts, "num_attempt", 1),
                         cwd=job_dir)
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

        for i in range(opts.num_servers):
            t = threading.Thread(target=run, args=("server", i), daemon=True)
            t.start()
            threads.append(t)
        for i in range(opts.num_workers):
            t = threading.Thread(target=run, args=("worker", i), daemon=True)
            t.start()
            threads.append(t)
        try:
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        finally:
            if job_dir is not None:
                shutil.rmtree(job_dir, ignore_errors=True)

    try:
        submit_job(opts, fun_submit, wait=False)
    except BaseException:
        # tracker bring-up can fail before fun_submit (and its finally)
        # ever runs; fun_submit's own cleanup already ran when it did run,
        # and rmtree(ignore_errors) is safe to repeat
        if job_dir is not None:
            shutil.rmtree(job_dir, ignore_errors=True)
        raise
