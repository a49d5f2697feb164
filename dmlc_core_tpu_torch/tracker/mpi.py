"""MPI backend: launch worker/server waves under mpirun.

Reference: tracker/dmlc_tracker/mpi.py:12-82 — OpenMPI-vs-MPICH env-flag
detection (23-35) and separate mpirun waves for servers and workers (55-77).

Counterpart of ``dmlc_core_tpu/tracker/mpi.py`` (a copy).  mpirun assigns
the ranks: a worker takes its rank from ``OMPI_COMM_WORLD_RANK`` (or
``PMIX_RANK``/``PMI_RANK``/``SLURM_PROCID``) through
``collective.api._task_id_from_env``.
"""

from __future__ import annotations

import logging
import subprocess
from functools import partial
from typing import Dict

from dmlc_core_tpu_torch.tracker.submit import run_ferried, submit_job

__all__ = ["submit"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def _detect_mpi_env_flag() -> str:
    """'-x' for OpenMPI, '-env' for MPICH (reference mpi.py:23-35)."""
    try:
        out = subprocess.run(["mpirun", "--version"], capture_output=True,
                             text=True, timeout=10).stdout.lower()
    except (OSError, subprocess.TimeoutExpired):
        return "-x"
    if "open mpi" in out or "open-rte" in out:
        return "-x"
    return "-env"


def submit(opts) -> None:
    flag = _detect_mpi_env_flag()

    def _mpirun(role: str, n: int, envs: Dict[str, str]) -> None:
        if n == 0:
            return
        cmd = ["mpirun", "-n", str(n)]
        if opts.host_file:
            cmd += ["--hostfile", opts.host_file]
        env = dict(envs)
        env["DMLC_ROLE"] = role
        env["DMLC_JOB_CLUSTER"] = "mpi"
        for k, v in env.items():
            if flag == "-x":
                cmd += ["-x", f"{k}={v}"]
            else:
                cmd += ["-env", k, str(v)]
        cmd += list(opts.command)
        logger.debug("mpirun: %s", " ".join(cmd))
        subprocess.check_call(cmd)

    def fun_submit(envs: Dict[str, str]) -> None:
        run_ferried([(f"mpirun for role {role}",
                      partial(_mpirun, role, n, envs))
                     for role, n in (("server", opts.num_servers),
                                     ("worker", opts.num_workers))])

    submit_job(opts, fun_submit, wait=False)
