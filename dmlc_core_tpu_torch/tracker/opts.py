"""The launcher's option schema (reference tracker/dmlc_tracker/opts.py:60-157).

Counterpart of ``dmlc_core_tpu/tracker/opts.py``: the same flags, choices
and defaults, so one argv parses to the same options in both packages.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["get_opts", "parse_memory_mb"]

CLUSTERS = ["local", "ssh", "mpi", "sge", "tpu-vm", "yarn", "mesos"]


def parse_memory_mb(text: str) -> int:
    """'4g'/'512m'/'1024' -> MB (reference opts.py:39-57)."""
    text = str(text).strip().lower()
    if text.endswith("g"):
        return int(float(text[:-1]) * 1024)
    if text.endswith("m"):
        return int(float(text[:-1]))
    return int(text)


def get_opts(args=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.tracker.submit",
        description="Submit a distributed dmlc_core_tpu_torch job.")
    parser.add_argument("--cluster", default=os.environ.get(
        "DMLC_SUBMIT_CLUSTER", "local"), choices=CLUSTERS,
        help="cluster backend (env default: DMLC_SUBMIT_CLUSTER)")
    parser.add_argument("--num-workers", type=int, required=True,
                        help="number of worker processes")
    parser.add_argument("--num-servers", type=int, default=0,
                        help="number of parameter-server processes")
    parser.add_argument("--worker-cores", type=int, default=1)
    parser.add_argument("--worker-memory", default="1g",
                        help="per-worker memory, e.g. 1g, 512m")
    parser.add_argument("--server-cores", type=int, default=1)
    parser.add_argument("--server-memory", default="1g")
    parser.add_argument("--jobname", default="dmlc-job")
    parser.add_argument("--queue", default="default")
    parser.add_argument("--log-level", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    parser.add_argument("--log-file", default=None)
    parser.add_argument("--host-file", default=None,
                        help="(ssh/mpi/tpu-vm) newline-separated worker hosts, "
                             "optionally host:port")
    parser.add_argument("--ssh-port", type=int, default=22)
    parser.add_argument("--sync-dst-dir", default=None,
                        help="(ssh/tpu-vm) rsync the working dir to this remote path")
    parser.add_argument("--host-ip", default=None,
                        help="tracker bind IP (default: auto-detect)")
    parser.add_argument("--env", action="append", default=[],
                        help="extra KEY=VALUE env to forward (repeatable)")
    parser.add_argument("--mesos-master", default=None,
                        help="(mesos) master host[:port]; default $MESOS_MASTER")
    parser.add_argument("--num-attempt", type=int,
                        default=int(os.environ.get("DMLC_NUM_ATTEMPT", "1")),
                        help="per-worker retry attempts (local backend)")
    parser.add_argument("--files", action="append", default=[],
                        help="file (src or src#dest) copied to the task "
                             "execution dir; repeatable (reference "
                             "opts.py:108-113)")
    parser.add_argument("--archives", action="append", default=[],
                        help="zip archive (src or src#dest) unpacked in the "
                             "task execution dir; repeatable — ship python "
                             "libs this way (reference opts.py:114-120)")
    parser.add_argument("--auto-file-cache",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="cache command-line tokens that name existing "
                             "files and rewrite them to ./basename "
                             "(reference opts.py:6-36); applies when the "
                             "backend stages a job dir (--files/--archives "
                             "given, or yarn/mesos)")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="worker command to run")
    opts = parser.parse_args(args)
    if opts.command and opts.command[0] == "--":
        opts.command = opts.command[1:]
    opts.worker_memory_mb = parse_memory_mb(opts.worker_memory)
    opts.server_memory_mb = parse_memory_mb(opts.server_memory)
    return opts
