#!/usr/bin/env python3
"""The control of a cell sharded by rows: the sharded reference in the
program's place, one precision step below what the configuration states.

    python3 portbench/control_dp.py --workload <cell> --seeds <n,n,...>

Starts the cell's ranks as a run does (:mod:`portbench.ranks`), each on its
own card, joined by ``torch.distributed`` alone (the port is not
imported).  For each seed every rank makes its shard as a run does, then
the ranks grow ``warmup_rounds + chunk_rounds`` trees with
:func:`portbench.reference.check_dp.build_tree_dp` (histograms and leaf
sums summed over the ranks) from g and h in float8 (e4m3) instead of
bfloat16 and leaf sums from TF32 inputs instead of a float32 matmul with
TF32 off, and judge them with the cell's own comparison.  Rank 0 prints one
JSON line per seed with the numbers and the cell's limits.  A sound
comparison calls every seed's control not correct.
"""

import argparse
import datetime
import json
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import ranks, shards  # noqa: E402
from portbench.control import LOWER  # noqa: E402
from portbench.kinds import on_card  # noqa: E402
from portbench.kinds.train import checked_trees  # noqa: E402
from portbench.kinds.train_dp import EXIT_S  # noqa: E402
from portbench.reference import check_dp  # noqa: E402


def child(args) -> None:
    """Ranks 1 and up, each in a child interpreter."""
    _control(args, {})


def _control(args, env):
    """Every seed's control on this rank; rank 0's JSON lines."""
    env = dict(os.environ, **env)
    rank, world = int(env["DMLC_TASK_ID"]), int(env["DMLC_NUM_WORKER"])
    cfg, spec = args["config"], args["spec"]
    if on_card(args["device"]):
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
        dev, backend = torch.device("cuda", int(env["LOCAL_RANK"])), "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{env['DMLC_COORDINATOR_URI']}:"
                             f"{env['DMLC_COORDINATOR_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(
            seconds=float(spec["collective_timeout_s"])))
    lines = []
    for seed in args["seeds"]:
        start = time.perf_counter()
        params = dict(args["params"], seed=seed)
        bins, label = shards.make_shard(
            cfg["data"], int(cfg["rows_per_rank"]), int(cfg["features"]),
            params["num_bins"], seed, rank, dev)
        first = int(spec["warmup_rounds"])
        total = first + int(spec["chunk_rounds"])
        margin = torch.zeros(bins.shape[0], dtype=torch.float32, device=dev)
        trees = []
        for t in range(total):
            sf, sb, lv, margin = check_dp.build_tree_dp(
                bins, margin, label, params, t, LOWER[cfg["hist_dtype"]],
                LOWER[cfg["leaf_sum_dtype"]])
            trees.append((sf, sb, lv, torch.zeros_like(sf,
                                                        dtype=torch.bool)))
        ens = tuple(torch.stack([tr[i] for tr in trees]) for i in range(4))
        checks = check_dp.judge_train_dp(
            bins, label, ens, margin, params, total,
            checked_trees(seed, first, total, spec["check_trees"]),
            cfg["hist_dtype"])
        limits = spec["limits"]
        lines.append({"seed": seed, "control_correct": all(
            v <= limits[k] for k, v in checks.items()), "checks": checks,
            "limits": limits, "seconds": time.perf_counter() - start})
        del bins, label, margin, ens, trees
    dist.destroy_process_group()
    return lines


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench.harness import Cell

    cell = Cell(args.workload)
    world = int(cell.config["ranks"])
    if device is None:
        if torch.cuda.device_count() < world:
            print(f"control_dp: {args.workload} needs {world} CUDA cards",
                  file=sys.stderr)
            return 2
        device = "cuda"
    job_args = {"config": cell.config, "spec": cell.spec,
                "params": cell.params(), "device": str(device),
                "seeds": [int(s) for s in args.seeds.split(",")]}
    with ranks.Job("portbench.control_dp:child", job_args, world) as job:
        lines = _control(job_args, job.env)
        job.finish(EXIT_S)
    for line in lines:
        print(json.dumps(dict(line, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
