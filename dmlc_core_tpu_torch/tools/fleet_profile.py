#!/usr/bin/env python3
"""Requests/s and latency of the replica fleet, per replica count.

Run from the root of a checkout on a machine with a CUDA card:

    python3 dmlc_core_tpu_torch/tools/fleet_profile.py \
        [--replicas 1,2,3,4] [--qps 400[,...]] [--seconds 10] [--rows N] \
        [--device cuda|cpu]

Fits chip_smoke.py's phase-4 model shape (HIGGS-shaped rows, 28 features,
256 bins, depth 6, 10 rounds) on ``--rows`` rows and saves it as a
``serving_state`` checkpoint.  For each replica count it starts a
``ReplicaFleet`` of that many card replicas (``python -m
dmlc_core_tpu_torch.serve``, each its own process and CUDA context, with
phase 9b's admission bound) behind a ``RouterServer`` in a process of its
own, and drives phase 9b's open-loop load (``run_load`` from this
process: 1-64 held-out rows a request, every 200 answer held bitwise to
``predict_float``) at each of the ``--qps`` rates for ``--seconds``.  It
prints offered and achieved requests/s, rows/s, p50/p95/p99 latency and
the outcome counts per count and rate, then the card's name and power
limit.  ``--device cpu`` runs the replicas on the host's cores instead:
set beside a card run, it tells whether the card or the host stops the
fleet from scaling with its replica count.
"""

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replicas", default="1,2,3,4")
    ap.add_argument("--qps", default="400")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.serve import ReplicaFleet, build_runtime
    from dmlc_core_tpu_torch.serve.loadgen import (PoolLoad, RouterProcess,
                                                   load_line)

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    x, y = cs.make_higgs_like(args.rows + cs.SERVE_POOL, cs.N_FEATURES)
    model = GBDT(GBDTParam(num_boost_round=cs.ROUNDS, max_depth=cs.MAX_DEPTH,
                           num_bins=cs.NUM_BINS, learning_rate=0.3),
                 num_feature=cs.N_FEATURES)
    model.make_bins(x[:50_000])
    ens, _ = model.fit_binned(model.bin_features(x[:args.rows]),
                              y[:args.rows])
    pool = x[args.rows:]
    root = os.path.join(ROOT, "build", "fleet_profile")
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(os.path.join(root, "ckpt"))
    mgr.save(1, model.serving_state(ens), async_=False)
    # the answers the replicas must give: their own device's float path
    want = build_runtime("gbdt", cs.N_FEATURES, checkpoint=mgr.step_uri(1),
                         device=args.device).predict_float(pool)
    load = PoolLoad(pool, {0: want}, max_rows=cs.SERVE_MAX_BATCH)
    for count in [int(c) for c in args.replicas.split(",")]:
        fleet = ReplicaFleet(count, model="gbdt", num_feature=cs.N_FEATURES,
                             checkpoint=mgr.step_uri(1), device=args.device,
                             max_queue_bytes=cs.TIER_QUEUE_BYTES,
                             log_dir=os.path.join(root, f"logs-{count}"))
        router = None
        try:
            fleet.start(timeout_s=cs.TIER_START_S)
            router = RouterProcess(fleet.urls)
            for qps in [float(q) for q in args.qps.split(",")]:
                report, rows_s, _ = load.run(router.url, qps, args.seconds,
                                             count, **cs.TIER_LOAD)
                label = f"{count} {args.device} replica(s)"
                print(f"{load_line(label, report, rows_s)} [{card}]",
                      flush=True)
        finally:
            if router is not None:
                router.close()
            fleet.close()
    shutil.rmtree(root, ignore_errors=True)
    print(card)


if __name__ == "__main__":
    main()
