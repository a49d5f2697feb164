"""CLI entry for the port's continuous trainer daemon.

Counterpart of ``dmlc_core_tpu/train/__main__.py``, with the reference's
flags plus ``--device`` (default ``cuda``; without a card the run raises
unless ``--device cpu`` is given).  Single-host spool::

    python -m dmlc_core_tpu_torch.train --data /spool --ckpt /ckpts \\
        --num-feature 16 --rounds-per-batch 2 --publish-every-rounds 4 \\
        --exit-when-idle

Fleet-fed (shard leases; coordinator address via
``DMLC_FLEET_LEASE_URI``/``DMLC_FLEET_LEASE_PORT`` or flags)::

    python -m dmlc_core_tpu_torch.train --fleet-worker w0 --ckpt /ckpts \\
        --num-feature 16

Telemetry rides the usual env bring-up (``DMLC_TELEMETRY_DIR``), chaos
the usual ``DMLC_FAULT_PLAN``; both are read at import.  The process is
designed to be killed: a supervisor restarting it with ``--incarnation``
bumped gets a daemon that resumes from the last valid manifest and
re-publishes anything torn.
"""

from __future__ import annotations

import argparse
import sys

from dmlc_core_tpu_torch.models.gbdt import GBDTParam
from dmlc_core_tpu_torch.train.daemon import TrainerDaemon
from dmlc_core_tpu_torch.train.source import DirectorySource, FleetSource
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import log_info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.train",
        description="continuous GBDT trainer daemon: ingest -> boost -> "
                    "publish manifest-first checkpoints for hot swap")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--data", help="spool directory of data files "
                     "(consumed once each, in name order)")
    src.add_argument("--fleet-worker", metavar="ID",
                     help="feed from the fleet shard-lease coordinator "
                          "as this worker id")
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory (URI or local path)")
    ap.add_argument("--num-feature", type=int, required=True)
    ap.add_argument("--fleet-host", default=None)
    ap.add_argument("--fleet-port", type=int, default=None)
    ap.add_argument("--rounds-per-batch", type=int, default=1)
    ap.add_argument("--publish-every-rounds", type=int, default=None,
                    help="publish cadence in boosting rounds "
                         "(DMLC_TRAIN_PUBLISH_ROUNDS, default 8)")
    ap.add_argument("--publish-every-s", type=float, default=None,
                    help="wall-clock publish cadence, 0=off "
                         "(DMLC_TRAIN_PUBLISH_EVERY_S)")
    ap.add_argument("--poll-s", type=float, default=None,
                    help="idle source poll (DMLC_TRAIN_POLL_S, default 0.5)")
    ap.add_argument("--keep", type=int, default=8,
                    help="checkpoint retention (local steps kept)")
    ap.add_argument("--max-batches", type=int, default=0,
                    help="stop after N consumed batches (0 = unbounded)")
    ap.add_argument("--exit-when-idle", action="store_true",
                    help="return once the source reports exhausted "
                         "(spool _DONE sentinel / fleet drained)")
    ap.add_argument("--incarnation", type=int, default=0,
                    help="supervisor restart counter; rides every train.* "
                         "fault context so chaos plans can target one life")
    ap.add_argument("--state-file", default=None,
                    help="atomic JSON progress snapshot for supervisors")
    ap.add_argument("--nan-fill", action="store_true",
                    help="densify absent features as NaN (handle_missing)")
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--max-depth", type=int, default=4)
    ap.add_argument("--num-bins", type=int, default=64)
    ap.add_argument("--objective", default="logistic",
                    choices=["logistic", "squared", "softmax"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # before any source starts: without a card this raises unless
    # --device cpu was given
    device = resolve_device(args.device)
    param = GBDTParam(learning_rate=args.learning_rate,
                      max_depth=args.max_depth, num_bins=args.num_bins,
                      objective=args.objective, handle_missing=args.nan_fill)
    if args.data:
        source = DirectorySource(args.data, args.num_feature,
                                 nan_fill=args.nan_fill)
    else:
        source = FleetSource(args.fleet_worker, args.num_feature,
                             host=args.fleet_host, port=args.fleet_port,
                             nan_fill=args.nan_fill).start()
    daemon = TrainerDaemon(
        args.ckpt, source, args.num_feature, param=param,
        rounds_per_batch=args.rounds_per_batch,
        publish_every_rounds=args.publish_every_rounds,
        publish_every_s=args.publish_every_s, poll_s=args.poll_s,
        keep=args.keep, incarnation=args.incarnation,
        state_file=args.state_file, device=device)
    daemon.run(max_batches=args.max_batches,
               exit_when_idle=args.exit_when_idle)
    final = daemon.describe()
    log_info(f"train: daemon done: {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
