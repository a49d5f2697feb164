"""Sun Grid Engine backend: qsub array job.

Reference: tracker/dmlc_tracker/sge.py — generates a run script exporting
``DMLC_TASK_ID=$SGE_TASK_ID`` and submits it as an array job.

Counterpart of ``dmlc_core_tpu/tracker/sge.py`` (a copy).  The run script
is written into the submitting directory (``qsub -cwd``).
"""

from __future__ import annotations

import logging
import os
import stat
import subprocess
from typing import Dict

from dmlc_core_tpu_torch.tracker.ssh import _shquote
from dmlc_core_tpu_torch.tracker.submit import submit_job

__all__ = ["submit"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def submit(opts) -> None:
    # file shipping (opt-in via --files/--archives: qsub -cwd already runs
    # tasks in the shared-FS submit dir): wrap the task in the launcher,
    # which materializes DMLC_JOB_FILES / unpacks DMLC_JOB_ARCHIVES into
    # the task cwd
    from dmlc_core_tpu_torch.tracker.filecache import prepare_shipping

    ship_env, command, _, _ = prepare_shipping(opts, wrap_launcher=True)

    def fun_submit(envs: Dict[str, str]) -> None:
        envs = {**envs, **ship_env}
        runscript = os.path.join(os.getcwd(), f"{opts.jobname}.sge.sh")
        with open(runscript, "w") as f:
            f.write("#!/bin/bash\n#$ -S /bin/bash\n")
            f.write(f"#$ -q {opts.queue}\n")
            f.write("GLOBAL_ID=$((SGE_TASK_ID - 1))\n")
            for k, v in envs.items():
                f.write(f"export {k}={_shquote(v)}\n")
            # task ids are role-relative (workers 0..nw-1, servers 0..ns-1):
            # DMLC_TASK_ID is the collective's process id, so a server
            # offset would corrupt worker rank identity (ssh.py computes
            # the same split)
            f.write('if [ "$GLOBAL_ID" -lt "%d" ]; then\n'
                    '  export DMLC_ROLE=server\n'
                    '  export DMLC_TASK_ID=$GLOBAL_ID\nelse\n'
                    '  export DMLC_ROLE=worker\n'
                    '  export DMLC_TASK_ID=$((GLOBAL_ID - %d))\nfi\n'
                    % (opts.num_servers, opts.num_servers))
            f.write(" ".join(map(_shquote, command)) + "\n")
        os.chmod(runscript, os.stat(runscript).st_mode | stat.S_IEXEC)
        n = opts.num_workers + opts.num_servers
        cmd = ["qsub", "-cwd", "-t", f"1-{n}",
               "-pe", "smp", str(opts.worker_cores),
               "-N", opts.jobname, runscript]
        logger.info("qsub: %s", " ".join(cmd))
        subprocess.check_call(cmd)

    submit_job(opts, fun_submit, wait=True)
