"""Container-side bootstrap (reference tracker/dmlc_tracker/launcher.py).

Counterpart of ``dmlc_core_tpu/tracker/launcher.py``.

Prepares the environment inside a freshly-scheduled container and execs the
worker command: copies job files (``DMLC_JOB_FILES``) and unpacks job
archives (``DMLC_JOB_ARCHIVES``) into the task cwd, assembles
``LD_LIBRARY_PATH``/``PYTHONPATH``, infers the role on SGE, then replaces
itself with the command.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

__all__ = ["main"]


def materialize_files(spec: str) -> None:
    """Copy '#'-renamable files listed in DMLC_JOB_FILES into the cwd
    (sources must be container-visible, e.g. on a shared filesystem).
    Copies land via a temp file + atomic replace so concurrent tasks in a
    shared cwd never see a half-written file."""
    for item in spec.split(":"):
        if not item:
            continue
        src, _, dest = item.partition("#")
        dest = dest or os.path.basename(src)
        if os.path.exists(src) and not os.path.exists(dest):
            fd, tmp = tempfile.mkstemp(prefix=".dmlc-file-",
                                       dir=os.path.dirname(dest) or ".")
            os.close(fd)
            shutil.copy2(src, tmp)
            os.replace(tmp, dest)


def unpack_archives(spec: str) -> None:
    """Unzip '#'-renamable archives listed in DMLC_JOB_ARCHIVES
    (atomic-rename extraction: safe under concurrent tasks sharing a
    cwd, e.g. SGE array jobs)."""
    from dmlc_core_tpu_torch.tracker.filecache import extract_archive_atomic

    for item in spec.split(":"):
        if not item:
            continue
        src, _, dest = item.partition("#")
        dest = dest or os.path.splitext(os.path.basename(src))[0]
        if os.path.exists(src):
            extract_archive_atomic(src, dest)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m dmlc_core_tpu_torch.tracker.launcher CMD [ARGS...]",
              file=sys.stderr)
        return 2
    env = os.environ
    cwd = env.get("DMLC_JOB_CWD")
    if cwd:
        os.makedirs(cwd, exist_ok=True)   # per-job sandboxes (tpu-vm)
        os.chdir(cwd)
    materialize_files(env.get("DMLC_JOB_FILES", ""))
    unpack_archives(env.get("DMLC_JOB_ARCHIVES", ""))
    # library paths
    extra_lib = [p for p in (env.get("DMLC_HDFS_OPTS", ""),) if p]
    ld = env.get("LD_LIBRARY_PATH", "")
    for p in (os.path.join(sys.prefix, "lib"),):
        if p not in ld:
            ld = f"{ld}:{p}" if ld else p
    env["LD_LIBRARY_PATH"] = ld
    if extra_lib:
        env["LIBHDFS_OPTS"] = " ".join(extra_lib)
    # role inference on SGE array jobs (reference launcher.py)
    if "SGE_TASK_ID" in env and "DMLC_TASK_ID" not in env:
        env["DMLC_TASK_ID"] = str(int(env["SGE_TASK_ID"]) - 1)
    return subprocess.call(argv, env=env)


if __name__ == "__main__":
    sys.exit(main())
