#!/usr/bin/env python3
"""The control of a cell's comparison: the reference in the program's
place, one precision step below what the configuration states.

    python3 portbench/control.py --workload <cell> --seeds <n,n,...>

Makes the cell's inputs from each seed as a run does, then lets the
reference produce what the window's program would: for a training cell
``warmup_rounds + chunk_rounds`` trees grown from the first round with the
histogram's g and h in float8 (e4m3) instead of bfloat16 and the leaf sums'
inputs in TF32 instead of a float32 matmul with TF32 off; for a scoring
cell a checked batch's scores with the margin summed in bfloat16 instead of
float32.  It judges that output with the cell's own comparison and prints
one JSON line per seed with the numbers and the cell's limits.  A sound
comparison calls every seed's control not correct.  Not part of a run: the
limits in ``workloads/<cell>.json`` are set from these readings and the
program's.
"""

import argparse
import json
import os
import random
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# one step below each precision a configuration states
LOWER = {"float32": "bfloat16", "float32 matmul, TF32 off": "tfloat32",
         "bfloat16": "float8_e4m3fn"}


def control_train(cell, seed: int, device):
    from portbench import data
    from portbench.kinds.train import checked_trees
    from portbench.reference import check, gbdt

    cfg, spec = cell.config, cell.spec
    params = dict(cell.params(), seed=seed)
    bins, label = data.make_rows(cfg["data"], int(cfg["rows"]),
                                 int(cfg["features"]), params["num_bins"],
                                 seed, device)
    first = int(spec["warmup_rounds"])
    total = first + int(spec["chunk_rounds"])
    margin = torch.zeros(bins.shape[0], dtype=torch.float32, device=device)
    trees = []
    for t in range(total):
        sf, sb, lv, margin = gbdt.build_tree(
            bins, margin, label, params, t, LOWER[cfg["hist_dtype"]],
            LOWER[cfg["leaf_sum_dtype"]])
        trees.append((sf, sb, lv, torch.zeros_like(sf, dtype=torch.bool)))
    ens = tuple(torch.stack([tr[i] for tr in trees]) for i in range(4))
    return check.judge_train(
        bins, label, ens, margin, params, total,
        checked_trees(seed, first, total, spec["check_trees"]),
        cfg["hist_dtype"])


def control_score(cell, seed: int, device):
    from portbench import data
    from portbench.reference import check

    cfg, spec = cell.config, cell.spec
    params = cell.params()
    batch = int(spec["batch_rows"])
    bins, _ = data.make_rows(cfg["data"], int(spec["table_rows"]),
                             int(cfg["features"]), params["num_bins"], seed,
                             device, with_label=False)
    trees = data.make_ensemble(int(spec["trees"]), params["max_depth"],
                               int(cfg["features"]), params["num_bins"],
                               float(spec["leaf_scale"]), seed, device)
    b = random.Random(seed).randrange(int(spec["table_rows"]) // batch)
    rows = bins[b * batch:(b + 1) * batch]
    low = getattr(torch, LOWER[cfg["margin_dtype"]])
    scores = check.reference_scores(rows, trees, params["max_depth"],
                                    dtype=low).to(torch.float32)
    return check.judge_score(rows, trees, scores, params["max_depth"])


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    from portbench.harness import Cell

    cell = Cell(args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
    fn = control_score if cell.spec["kind"] == "score" else control_train
    limits = cell.spec["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        checks = fn(cell, seed, device)
        correct = all(v <= limits[k] for k, v in checks.items())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": correct, "checks": checks,
                          "limits": limits,
                          "seconds": time.perf_counter() - start}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
