"""The launcher: start tracker + coordinator, dispatch to a cluster backend.

Counterpart of ``dmlc_core_tpu/tracker/submit.py`` (reference
tracker/dmlc_tracker/submit.py:37-53 for the dispatch, tracker.py:410-433
for ``submit()``: tracker startup + env assembly)::

    python -m dmlc_core_tpu_torch.tracker.submit --cluster local \
        --num-workers 2 -- python -m dmlc_core_tpu_torch.examples.train_gbdt \
        --data f.libsvm --num-feature 28

Env contract handed to every worker (the reference's, letter for letter):
- ``DMLC_TRACKER_URI`` / ``DMLC_TRACKER_PORT``   — Rabit rendezvous (for
  wire-compatible Rabit clients), with ``DMLC_TRACKER_TRACEPARENT``;
- ``DMLC_NUM_WORKER`` / ``DMLC_NUM_SERVER`` / ``DMLC_JOB_CLUSTER`` — world
  shape and backend;
- ``DMLC_COORDINATOR_URI`` / ``DMLC_COORDINATOR_PORT`` — the store that
  rank 0 hosts for the ``torch.distributed`` process group
  (:func:`dmlc_core_tpu_torch.collective.init` consumes it);
- ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` when servers are asked for;
- per-task: ``DMLC_TASK_ID``, ``DMLC_ROLE``, ``DMLC_NUM_ATTEMPT``.

``--cluster`` picks the backend as in the reference: ``local``, ``ssh``,
``mpi``, ``sge``, ``tpu-vm``, ``yarn`` or ``mesos``.
"""

from __future__ import annotations

import logging
import socket
import sys
import threading
from typing import Callable, Dict, List, Sequence, Tuple

from dmlc_core_tpu_torch.tracker.rendezvous import PSTracker, RabitTracker, bind_free_port

__all__ = ["submit_job", "run_ferried", "main"]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def run_ferried(tasks: Sequence[Tuple[str, Callable[[], None]]]) -> None:
    """Run ``(label, thunk)`` tasks on daemon threads, join them all, and
    re-raise the first failure.

    The one ferrying stanza shared by the ssh/mpi/tpu-vm backends: a thread
    target that raises dies silently in ``Thread.run`` and ``join()``
    reports success over a dead task (the dmlclint lockset-thread-leak
    rule), so every task's exception is logged under its label and the
    first one propagates to the caller after all tasks finish."""
    errors: List[BaseException] = []

    def run(label: str, thunk: Callable[[], None]) -> None:
        try:
            thunk()
        except BaseException as exc:  # noqa: BLE001 - ferried to caller
            logger.error("%s failed: %s", label, exc)
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(label, thunk), daemon=True)
               for label, thunk in tasks]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _default_host_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    except OSError:
        return "127.0.0.1"
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        # the old shape leaked the probe socket here: connect() failing
        # (no route) jumped past s.close() straight to the handler
        return "127.0.0.1"
    finally:
        s.close()


def submit_job(opts, fun_submit: Callable[[Dict[str, str]], None],
               wait: bool = True) -> RabitTracker:
    """Start the tracker, build worker envs, and hand off to the backend's
    ``fun_submit(envs)`` (reference tracker.py:410-433)."""
    host_ip = opts.host_ip or _default_host_ip()
    tracker = RabitTracker(host_ip, opts.num_workers)
    tracker.start(opts.num_workers)

    envs = {
        "DMLC_NUM_WORKER": str(opts.num_workers),
        "DMLC_NUM_SERVER": str(opts.num_servers),
        "DMLC_JOB_CLUSTER": opts.cluster,
    }
    envs.update(tracker.worker_envs())
    # allocate a coordinator port for the store (rank 0 binds it)
    coord_sock, coord_port = bind_free_port(host_ip, 12321, 12999)
    coord_sock.close()
    envs["DMLC_COORDINATOR_URI"] = host_ip
    envs["DMLC_COORDINATOR_PORT"] = str(coord_port)
    if opts.num_servers > 0:
        ps = PSTracker(host_ip, cmd=None)
        envs.update(ps.worker_envs())
    for kv in getattr(opts, "env", []):
        key, _, value = kv.partition("=")
        envs[key] = value

    fun_submit(envs)
    if wait:
        tracker.join()
    return tracker


def main(argv=None) -> int:
    from dmlc_core_tpu_torch.tracker.opts import get_opts

    opts = get_opts(argv)
    logging.basicConfig(
        level=getattr(logging, opts.log_level),
        filename=opts.log_file,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if not opts.command:
        print("error: no worker command given", file=sys.stderr)
        return 2
    if opts.cluster == "local":
        from dmlc_core_tpu_torch.tracker import local as backend
    elif opts.cluster == "ssh":
        from dmlc_core_tpu_torch.tracker import ssh as backend
    elif opts.cluster == "mpi":
        from dmlc_core_tpu_torch.tracker import mpi as backend
    elif opts.cluster == "sge":
        from dmlc_core_tpu_torch.tracker import sge as backend
    elif opts.cluster == "tpu-vm":
        from dmlc_core_tpu_torch.tracker import tpu_vm as backend
    elif opts.cluster == "yarn":
        from dmlc_core_tpu_torch.tracker import yarn as backend
    elif opts.cluster == "mesos":
        from dmlc_core_tpu_torch.tracker import mesos as backend
    else:
        print(f"error: unknown cluster backend {opts.cluster!r}",
              file=sys.stderr)
        return 2
    backend.submit(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
