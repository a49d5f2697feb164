"""TPU-VM backend: one process per host of a TPU-VM slice.

Counterpart of ``dmlc_core_tpu/tracker/tpu_vm.py`` (a copy; the option
keeps its name, ``--cluster tpu-vm``).  It launches the worker command on
every host of a slice and lets ``dmlc_core_tpu_torch.collective.init``
bring up the ``torch.distributed`` process group from the env contract.

Two launch paths:
- with ``--host-file``: ssh to each host (reuses the ssh machinery);
- without: shell out to ``gcloud compute tpus tpu-vm ssh --worker=all`` using
  ``TPU_NAME``/``TPU_ZONE`` env (the standard gcloud flow); each host's
  ``DMLC_TASK_ID`` expands from its own ``TPU_WORKER_ID``.

The per-rank count is *hosts*: ``--num-workers`` is the host count of the
slice.  Rank recovery keeps the reference's jobid semantics, but a lost
host means the whole job restarts and resumes from the latest checkpoint
(bridge.checkpoint), not per-rank healing.
"""

from __future__ import annotations

import logging
import os
import subprocess
import uuid
from functools import partial
from typing import Dict

from dmlc_core_tpu_torch.tracker.submit import run_ferried, submit_job
from dmlc_core_tpu_torch.tracker.ssh import (FORWARD_ENV, _shquote,
                                             _ssh_command, parse_host_file)

__all__ = ["submit"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def _gcloud_cmd(env: Dict[str, str], command) -> list:
    tpu_name = os.environ.get("TPU_NAME")
    zone = os.environ.get("TPU_ZONE", "")
    assert tpu_name, "tpu-vm backend needs --host-file or TPU_NAME env"
    exports = "; ".join(f"export {k}={_shquote(v)}" for k, v in env.items())
    # the per-host task id MUST expand on the remote host (every host gets
    # the same command line; only TPU_WORKER_ID differs there) — a quoted
    # literal would give every host process id 0 and deadlock rendezvous
    exports += '; export DMLC_TASK_ID="${TPU_WORKER_ID:-0}"'
    remote = f"{exports}; {' '.join(map(_shquote, command))}"
    cmd = ["gcloud", "compute", "tpus", "tpu-vm", "ssh", tpu_name,
           "--worker=all", f"--command={remote}"]
    if zone:
        cmd.append(f"--zone={zone}")
    return cmd


def submit(opts) -> None:
    # file shipping (opt-in via --files/--archives): host-file path ships
    # by scp like the ssh backend; the gcloud path exports the
    # DMLC_JOB_FILES/ARCHIVES contract and wraps the command in the
    # launcher, which materializes from host-visible sources (e.g. the
    # GCS-fused paths TPU-VMs mount)
    from dmlc_core_tpu_torch.tracker.filecache import (prepare_scp_shipping,
                                                       wrap_launcher_cmd)
    from dmlc_core_tpu_torch.tracker.ssh import _unpack_prelude, ship_files

    ship_env, command, shipped, archives = prepare_scp_shipping(opts)
    prelude = _unpack_prelude(archives)

    def fun_submit(envs: Dict[str, str]) -> None:
        base_env = dict(envs)
        for key in FORWARD_ENV:
            if key in os.environ:
                base_env.setdefault(key, os.environ[key])
        if opts.host_file:
            hosts = parse_host_file(opts.host_file, opts.ssh_port)
            assert len(hosts) >= opts.num_workers, \
                "host file has fewer hosts than --num-workers"
            workdir = opts.sync_dst_dir or "."
            for host, port in set(hosts[:opts.num_workers]):
                ship_files(shipped, host, port, workdir)
            tasks = []
            for taskid in range(opts.num_workers):
                host, port = hosts[taskid]
                env = dict(base_env)
                env["DMLC_ROLE"] = "worker"
                env["DMLC_TASK_ID"] = str(taskid)
                cmd = _ssh_command(host, port, env, workdir, command,
                                   prelude=prelude)
                tasks.append((f"tpu-vm worker {taskid}",
                              partial(subprocess.check_call, cmd)))
            run_ferried(tasks)
        else:
            # gcloud path: the TPU runtime provides per-host task ids via
            # TPU_WORKER_ID; _gcloud_cmd emits the (unquoted, host-side)
            # DMLC_TASK_ID export itself.
            env = dict(base_env)
            env["DMLC_ROLE"] = "worker"
            gcmd = command
            if ship_env:
                env.update(ship_env)
                # the gcloud ssh session lands in the VM user's persistent
                # home dir — materializing there would serve STALE files on
                # resubmit (skip-if-exists semantics); give every job its
                # own cwd, which the launcher creates and chdirs into
                env["DMLC_JOB_CWD"] = (f"dmlc-jobs/{opts.jobname}-"
                                       f"{uuid.uuid4().hex[:8]}")
                gcmd = wrap_launcher_cmd(command)
            subprocess.check_call(_gcloud_cmd(env, gcmd))

    submit_job(opts, fun_submit, wait=False)
