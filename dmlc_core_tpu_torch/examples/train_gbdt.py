"""Hist-GBDT training over the port's data pipeline, on the card.

The port's counterpart of ``examples/train_gbdt.py``'s single-host flow,
with the same flags plus ``--device``::

    python -m dmlc_core_tpu_torch.examples.train_gbdt \\
        --data 'higgs.csv?format=csv&label_column=0' \\
        --num-feature 28 --rounds 50 --max-depth 6

Steps: ``create_parser`` -> ``dense_batches(8192)`` under a
``ThroughputMeter("ingest")`` -> quantile edges on the first <=100,000
rows -> ``HostBinner`` to the uint8 wire -> ``DeviceFeedLoader`` into one
preallocated ``[N, F]`` tensor on the device (padding rows dropped by
``num_rows``) -> ``fit_binned``.  The dense batches of the ingest pass are
binned as they are (what ``binned_batches`` does), so the file is parsed
once.  ``--device`` defaults to ``cuda`` and there is no quiet CPU
fallback: pass ``--device cpu`` to run the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

SAMPLE_ROWS = 100_000
BATCH_ROWS = 8192


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.examples.train_gbdt")
    ap.add_argument("--data", required=True)
    ap.add_argument("--num-feature", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--num-bins", type=int, default=256)
    ap.add_argument("--learning-rate", type=float, default=0.3)
    ap.add_argument("--hist-method", default="auto",
                    choices=["auto", "pallas", "pallas_fused", "onehot",
                             "scatter"],
                    help="histogram algorithm (auto: the CUDA kernel on "
                         "the card, scatter on the CPU)")
    ap.add_argument("--objective", default="logistic",
                    choices=["logistic", "squared", "softmax"])
    ap.add_argument("--num-class", type=int, default=1,
                    help="classes for --objective softmax")
    ap.add_argument("--min-split-loss", type=float, default=0.0,
                    help="gamma: minimum gain to split")
    ap.add_argument("--reg-alpha", type=float, default=0.0,
                    help="L1 on leaf weights")
    ap.add_argument("--monotone-constraints", default="",
                    help="per-feature directions, e.g. '(1,0,-1)'")
    ap.add_argument("--scale-pos-weight", type=float, default=1.0,
                    help="positive-class weight multiplier (logistic)")
    ap.add_argument("--subsample", type=float, default=1.0)
    ap.add_argument("--colsample-bytree", type=float, default=1.0)
    ap.add_argument("--colsample-bylevel", type=float, default=1.0)
    ap.add_argument("--colsample-bynode", type=float, default=1.0)
    ap.add_argument("--max-delta-step", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--handle-missing", action="store_true",
                    help="sparsity-aware splits: absent/NaN features take "
                         "a reserved bin with learned default directions")
    ap.add_argument("--eval-data", default="")
    ap.add_argument("--early-stopping-rounds", type=int, default=0)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None):
    """Train and print the ingest and ``trained ...`` lines; returns the
    ensemble and the final training margin."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.eval_data or args.early_stopping_rounds:
        ap.error("--eval-data/--early-stopping-rounds are not yet in the "
                 "PyTorch port (ROADMAP §1 item 6, GBDT extras)")
    if args.checkpoint or args.checkpoint_dir:
        ap.error("--checkpoint/--checkpoint-dir are not yet in the PyTorch "
                 "port (ROADMAP §1 item 3, GBDT persistence)")

    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.batching import dense_batches
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.bridge.loader import DeviceFeedLoader
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.parallel.mesh import local_shard_info
    from dmlc_core_tpu_torch.utils.profiler import ThroughputMeter
    from dmlc_core_tpu_torch.utils.timer import device_time

    # under a tracker launch the worker world shows only after init; gloo,
    # since the collective serves only to find that world here
    collective.init({"backend": "gloo"})
    part, nparts = local_shard_info()
    if nparts > 1:
        collective.finalize()
        ap.error(f"a launch of {nparts} workers is not yet in the PyTorch "
                 f"port (ROADMAP §1: the CLI's multi-worker path); it "
                 f"trains one model on one host and never per-shard models")
    param = GBDTParam(num_boost_round=args.rounds, max_depth=args.max_depth,
                      num_bins=args.num_bins, learning_rate=args.learning_rate,
                      hist_method=args.hist_method,
                      min_split_loss=args.min_split_loss,
                      reg_alpha=args.reg_alpha,
                      monotone_constraints=args.monotone_constraints,
                      scale_pos_weight=args.scale_pos_weight,
                      subsample=args.subsample,
                      colsample_bytree=args.colsample_bytree,
                      colsample_bylevel=args.colsample_bylevel,
                      colsample_bynode=args.colsample_bynode,
                      max_delta_step=args.max_delta_step, seed=args.seed,
                      objective=args.objective, num_class=args.num_class,
                      handle_missing=args.handle_missing)
    # resolves the device first: no card and no --device cpu raises here,
    # before any file is read
    model = GBDT(param, num_feature=args.num_feature, device=args.device)

    parser = create_parser(args.data, part, nparts, type="auto")
    fill = np.nan if args.handle_missing else 0.0
    meter = ThroughputMeter("ingest")
    batches, seen = [], 0
    try:
        for batch in dense_batches(parser, BATCH_ROWS, args.num_feature,
                                   fill_value=fill):
            batches.append(batch)
            read = parser.bytes_read()
            meter.add(read - seen, nrows=batch.num_rows)
            seen = read
    finally:
        parser.close()
    print(meter.summary())
    n = sum(b.num_rows for b in batches)
    if n == 0:
        ap.error(f"no rows in {args.data!r}")

    sample, have = [], 0
    for b in batches:
        if have >= SAMPLE_ROWS:
            break
        sample.append(b.x[:b.num_rows].numpy())
        have += b.num_rows
    model.make_bins(np.concatenate(sample)[:SAMPLE_ROWS], count=n)
    binner = HostBinner(model.boundaries, args.num_bins,
                        handle_missing=args.handle_missing)
    wire = torch.from_numpy(np.empty(0, binner.dtype)).dtype
    bins = torch.empty((n, args.num_feature), dtype=wire, device=model.device)
    label = torch.empty(n, dtype=torch.float32, device=model.device)
    row = 0
    for b in DeviceFeedLoader(lambda: map(binner.transform_batch, batches),
                              device=model.device):
        k = b.num_rows
        bins[row:row + k] = b.bins[:k]
        label[row:row + k] = b.label[:k]
        row += k
    del batches

    model.fit_binned(bins, label)      # warm-up: kernel build and caches
    (ensemble, margin), secs = device_time(model.fit_binned, bins, label)
    if args.objective == "softmax":
        acc = (margin.argmax(1) == label).float().mean().item()
    else:
        acc = ((margin > 0).float() == label).float().mean().item()
    rows_per_sec = n * args.rounds / secs
    print(f"trained {args.rounds} rounds on {n} rows in {secs:.2f}s "
          f"({rows_per_sec:,.0f} rows/sec/chip), train acc {acc:.4f}")
    collective.finalize()
    return ensemble, margin


if __name__ == "__main__":
    main()
