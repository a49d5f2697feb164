"""Job file cache: ship files/archives named at submit time to the
execution environment.

Counterpart of ``dmlc_core_tpu/tracker/filecache.py``, whole.

Reference semantics (tracker/dmlc_tracker/opts.py:6-36 auto cache-file set;
opts.py:108-126 the ``--files``/``--archives`` options; consumed via
``DMLC_JOB_ARCHIVES``, yarn.py:96): with auto-file-cache on, every command
token that names an existing file is shipped to the executor and the token
rewritten to ``./basename``; ``--files`` adds explicit extras; ``--archives``
lists zip files unpacked in the execution dir.  The reference wires this
only for YARN; here one module serves every backend:

- **local** stages into a per-job temp dir and runs workers there;
- **ssh** copies the staged set into the remote workdir next to the rsync;
- **yarn / mesos / sge** export the ``DMLC_JOB_FILES`` /
  ``DMLC_JOB_ARCHIVES`` env contract (``:``-separated ``src#dest`` items)
  and the container-side launcher materializes them into the task cwd.

Entries use the reference's ``src#dest`` spelling throughout — the ``dest``
rename survives into staging/shipping.  ``dest`` defaults to the source
basename (for archives: basename without the zip extension).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import zipfile
from typing import Dict, List, Tuple

__all__ = ["collect_job_files", "stage_job_dir", "files_env",
           "prepare_shipping", "prepare_scp_shipping", "wrap_launcher_cmd",
           "split_spec_item", "extract_archive_atomic"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def split_spec_item(item: str, archive: bool = False) -> Tuple[str, str]:
    """``src#dest`` -> (src, dest); dest defaults to basename (archives:
    basename without the zip extension, the reference launcher rule)."""
    src, _, dest = item.partition("#")
    if not dest:
        base = os.path.basename(src)
        dest = os.path.splitext(base)[0] if archive else base
    return src, dest


def collect_job_files(opts) -> Tuple[List[str], List[str], List[str]]:
    """Resolve the job's file-cache set from the submit options.

    Returns ``(files, archives, command)``: both lists hold normalized
    ``src#dest`` specs (absolute sources, deduped by source, command order
    first), and the command has every auto-cached token rewritten to
    ``./basename`` — e.g. ``../../kmeans ../kmeans.conf`` becomes
    ``./kmeans ./kmeans.conf`` running in the staged dir.
    """
    files: List[str] = []
    seen = set()

    def _add(src: str, dest: str) -> bool:
        src = os.path.abspath(src)
        if not os.path.isfile(src):
            return False
        if src not in seen:
            seen.add(src)
            files.append(f"{src}#{dest}")
        return True

    command = []
    auto = getattr(opts, "auto_file_cache", True)
    for tok in getattr(opts, "command", []):
        if auto and os.path.isfile(tok):
            _add(tok, os.path.basename(tok))
            command.append("./" + os.path.basename(tok))
        else:
            command.append(tok)
    for item in getattr(opts, "files", []) or []:
        src, dest = split_spec_item(item)
        if not _add(src, dest):
            logger.warning("--files entry %r does not exist; skipped", item)
    archives = []
    for item in getattr(opts, "archives", []) or []:
        src, dest = split_spec_item(item, archive=True)
        src = os.path.abspath(src)
        if not os.path.isfile(src):
            logger.warning("--archives entry %r does not exist; skipped",
                           item)
            continue
        archives.append(f"{src}#{dest}")
    return files, archives, command


def extract_archive_atomic(src: str, dest: str) -> None:
    """Unpack ``src`` so ``dest`` only ever appears fully extracted:
    extract into a sibling temp dir, then rename into place.  Concurrent
    extractors (SGE array tasks in one qsub -cwd, several ssh workers per
    host) race safely — the rename loser discards its copy and uses the
    winner's, which is complete by rename-atomicity."""
    if os.path.exists(dest):
        return
    parent = os.path.dirname(os.path.abspath(dest)) or "."
    tmp = tempfile.mkdtemp(prefix=".dmlc-unpack-", dir=parent)
    try:
        with zipfile.ZipFile(src) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            # rename-race loser: the winner's fully-extracted copy serves
            if not os.path.exists(dest):
                raise
    finally:
        # after a successful rename tmp no longer exists and this no-ops;
        # on ANY failure (BadZipFile included, which the old except OSError
        # arm leaked) the temp dir is removed
        shutil.rmtree(tmp, ignore_errors=True)


def stage_job_dir(files: List[str], archives: List[str],
                  dest_dir: str) -> None:
    """Materialize the cache set into ``dest_dir`` (the local-backend
    execution dir): copy files under their dest names (permissions
    preserved, so shipped binaries stay executable) and unpack archives —
    ``dest_dir`` plays the role of the container sandbox, where the
    launcher would unpack."""
    os.makedirs(dest_dir, exist_ok=True)
    for item in files:
        src, dest = split_spec_item(item)
        shutil.copy2(src, os.path.join(dest_dir, dest))
    for item in archives:
        src, dest = split_spec_item(item, archive=True)
        extract_archive_atomic(src, os.path.join(dest_dir, dest))


def files_env(files: List[str], archives: List[str]) -> Dict[str, str]:
    """The env contract consumed by the container-side launcher:
    ``DMLC_JOB_FILES`` / ``DMLC_JOB_ARCHIVES`` as ``:``-separated
    ``src#dest`` lists (sources must be visible from the container — a
    shared filesystem or resources the cluster itself localizes)."""
    env: Dict[str, str] = {}
    if files:
        env["DMLC_JOB_FILES"] = ":".join(files)
    if archives:
        env["DMLC_JOB_ARCHIVES"] = ":".join(archives)
    return env


def prepare_shipping(opts, wrap_launcher: bool = False,
                     always: bool = False):
    """The one ship-prep stanza shared by every backend.

    Returns ``(ship_env, command, files, archives)``.  Shipping activates
    when ``--files``/``--archives`` were given, or — for backends whose
    execution dir is always a fresh container sandbox (``always=True``,
    yarn/mesos, matching the reference's always-on YARN auto-cache) — when
    auto-file-cache is enabled.  ``wrap_launcher`` prefixes the command
    with the container-side launcher for backends that don't already
    route through it.
    """
    explicit = bool(getattr(opts, "files", None)
                    or getattr(opts, "archives", None))
    auto = getattr(opts, "auto_file_cache", True)
    if not explicit and not (always and auto):
        return {}, list(getattr(opts, "command", [])), [], []
    files, archives, command = collect_job_files(opts)
    env = files_env(files, archives)
    if wrap_launcher and (files or archives):
        command = wrap_launcher_cmd(command)
    return env, command, files, archives


def remote_python() -> str:
    """Interpreter name to use in remote/container command lines.  Default
    ``python3``: a bare ``python`` does not exist on python3-only hosts
    (default Debian/Ubuntu and most cluster images).  Overridable for
    clusters whose interpreter lives elsewhere."""
    return os.environ.get("DMLC_REMOTE_PYTHON", "python3")


def wrap_launcher_cmd(command: List[str]) -> List[str]:
    """Route a task command through the container-side launcher (which
    materializes DMLC_JOB_FILES / unpacks DMLC_JOB_ARCHIVES)."""
    return [remote_python(), "-m", "dmlc_core_tpu_torch.tracker.launcher"] \
        + list(command)


def prepare_scp_shipping(opts):
    """The ssh-style backends' ship-prep (ssh + tpu-vm host-file path):
    returns ``(ship_env, command, scp_specs, archives)`` where
    ``scp_specs`` is every file spec plus each archive zip under its
    basename (the form the remote unpack prelude expects)."""
    ship_env, command, files, archives = prepare_shipping(opts)
    scp_specs = list(files)
    for item in archives:
        src, _ = split_spec_item(item, archive=True)
        scp_specs.append(f"{src}#{os.path.basename(src)}")
    return ship_env, command, scp_specs, archives
