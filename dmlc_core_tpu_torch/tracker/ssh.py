"""SSH backend: launch workers over ssh with env forwarding + workdir rsync.

Reference: tracker/dmlc_tracker/ssh.py:13-85 — host-file parsing with optional
ports (43-53), rsync of the working dir (13-21), env-forward whitelist
including cloud credentials (26-27).

Counterpart of ``dmlc_core_tpu/tracker/ssh.py`` (a copy; ``FORWARD_ENV`` is
the reference's list).
"""

from __future__ import annotations

import inspect
import logging
import os
import subprocess
from functools import partial
from typing import Dict, List, Tuple

from dmlc_core_tpu_torch.tracker.filecache import extract_archive_atomic
from dmlc_core_tpu_torch.tracker.submit import run_ferried, submit_job

__all__ = ["submit", "parse_host_file"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")

# env vars forwarded to remote workers (reference ssh.py:26-27 + TPU additions)
FORWARD_ENV = [
    "LD_LIBRARY_PATH", "PYTHONPATH", "DMLC_INTERFACE",
    "AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN",
    "AWS_REGION", "GOOGLE_APPLICATION_CREDENTIALS",
    "TPU_NAME", "JAX_PLATFORMS",
]


def parse_host_file(path: str, default_port: int = 22) -> List[Tuple[str, int]]:
    """Lines of ``host`` or ``host:port`` (reference ssh.py:43-53)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if ":" in line:
                host, port = line.rsplit(":", 1)
                hosts.append((host, int(port)))
            else:
                hosts.append((line, default_port))
    return hosts


def sync_dir(local_dir: str, host: str, port: int, remote_dir: str) -> None:
    """rsync the working directory to the remote host (reference ssh.py:13-21)."""
    cmd = ["rsync", "-az", "--rsh", f"ssh -o StrictHostKeyChecking=no -p {port}",
           local_dir + "/", f"{host}:{remote_dir}/"]
    logger.debug("rsync: %s", " ".join(cmd))
    subprocess.check_call(cmd)


def ship_files(specs: List[str], host: str, port: int,
               remote_dir: str) -> None:
    """scp the job's cached ``src#dest`` entries into the remote workdir
    under their dest names (the ssh-backend leg of the --files/--archives
    contract)."""
    from dmlc_core_tpu_torch.tracker.filecache import split_spec_item

    for item in specs:
        src, dest = split_spec_item(item)
        cmd = ["scp", "-o", "StrictHostKeyChecking=no", "-P", str(port),
               src, f"{host}:{remote_dir}/{dest}"]
        logger.debug("scp: %s", " ".join(cmd))
        subprocess.check_call(cmd)


# remote unpack program: the REAL filecache.extract_archive_atomic source
# (stdlib-only by construction), not a hand-maintained string twin — the
# twins drifted once already (the BadZipFile temp-dir leak was fixed in
# the function but originally shipped in both copies)
_REMOTE_UNZIP = (
    "import os, shutil, sys, tempfile, zipfile\n"
    + inspect.getsource(extract_archive_atomic)
    + "extract_archive_atomic(sys.argv[1], sys.argv[2])\n")


def _unpack_prelude(archives: List[str]) -> str:
    """Remote shell prelude unpacking shipped archives with a stdlib-only
    python one-liner (no framework install needed on the remote side);
    dest naming matches the launcher's src#dest rule."""
    from dmlc_core_tpu_torch.tracker.filecache import (remote_python,
                                                       split_spec_item)

    steps = []
    for item in archives:
        src, dest = split_spec_item(item, archive=True)
        # the zip was shipped under its basename into the workdir
        steps.append(f"{remote_python()} -c {_shquote(_REMOTE_UNZIP)} "
                     f"{_shquote(os.path.basename(src))} {_shquote(dest)}")
    return "; ".join(steps)


def _ssh_command(host: str, port: int, env: Dict[str, str], workdir: str,
                 cmd: List[str], prelude: str = "") -> List[str]:
    exports = "; ".join(f"export {k}={_shquote(v)}" for k, v in env.items())
    steps = [exports, f"cd {_shquote(workdir)}"]
    if prelude:
        steps.append(prelude)
    steps.append(f"exec {' '.join(map(_shquote, cmd))}")
    return ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(port), host,
            "; ".join(steps)]


def _shquote(s: str) -> str:
    import shlex

    return shlex.quote(str(s))


def submit(opts) -> None:
    assert opts.host_file, "--host-file is required for the ssh backend"
    hosts = parse_host_file(opts.host_file, opts.ssh_port)

    # file shipping: cached files + archives ride next to the rsync; the
    # command is rewritten to ./basename only when shipping is active
    from dmlc_core_tpu_torch.tracker.filecache import prepare_scp_shipping

    _, command, shipped, archives = prepare_scp_shipping(opts)
    prelude = _unpack_prelude(archives)

    def fun_submit(envs: Dict[str, str]) -> None:
        workdir = opts.sync_dst_dir or os.getcwd()
        if opts.sync_dst_dir:
            for host, port in set(hosts):
                sync_dir(os.getcwd(), host, port, opts.sync_dst_dir)
        for host, port in set(hosts):
            ship_files(shipped, host, port, workdir)
        tasks = []
        for i in range(opts.num_workers + opts.num_servers):
            role = "server" if i < opts.num_servers else "worker"
            taskid = i if role == "server" else i - opts.num_servers
            host, port = hosts[i % len(hosts)]
            env = dict(envs)
            env["DMLC_ROLE"] = role
            env["DMLC_TASK_ID"] = str(taskid)
            for key in FORWARD_ENV:
                if key in os.environ:
                    env.setdefault(key, os.environ[key])
            cmd = _ssh_command(host, port, env, workdir, command,
                               prelude=prelude)
            tasks.append((f"ssh task {role}:{taskid}",
                          partial(subprocess.check_call, cmd)))
        run_ferried(tasks)

    submit_job(opts, fun_submit, wait=False)
