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

Under a launch of several workers (``python -m
dmlc_core_tpu_torch.tracker.submit --cluster local --num-workers N --
python -m dmlc_core_tpu_torch.examples.train_gbdt ...``) every rank reads
its byte-range shard, the quantile sketch is merged over the ranks, and
the ranks fit ONE global model, data-parallel (``_fit_distributed``, after
the reference's): every rank pads to the largest shard with weight-0 rows,
fits under a ``data`` mesh over all ranks (the histograms all-reduced on
every level), and prints the same ``trained ... over N workers`` line with
the global accuracy; rank 0 writes ``--checkpoint``.  The collective runs
over gloo, so ranks may share one card; each rank takes card ``(LOCAL_RANK
or task id) % device_count``.  ``--eval-data`` and ``--checkpoint-dir``
are single-host flows and refuse such a launch, as in the reference.

The reference's single-host flows are all here:

- ``--eval-data URI [--early-stopping-rounds N]``: ``fit_with_eval`` on
  the held-out file (binned with the training edges), printing the first
  and last eval loss and the trees kept;
- ``--checkpoint-dir DIR [--checkpoint-every K]``: a round-by-round fit
  (``boost_round(round_index=r)``) that saves the margin and the trees so
  far every K rounds through ``CheckpointManager``; rerunning with the
  same directory resumes at the latest step.  The step payload is the
  reference's, so either package resumes the other's;
- ``--checkpoint URI``: the trained ensemble's arrays, saved at the end.
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
    ap.add_argument("--eval-data", default="",
                    help="held-out URI: track per-round eval loss "
                         "(logloss/mlogloss/MSE per objective)")
    ap.add_argument("--early-stopping-rounds", type=int, default=0,
                    help="stop when eval loss hasn't improved for N rounds "
                         "(needs --eval-data); the ensemble truncates to "
                         "the best round")
    ap.add_argument("--checkpoint", default="",
                    help="URI to save the trained ensemble's arrays to")
    ap.add_argument("--checkpoint-dir", default="",
                    help="resumable training: step-numbered checkpoints "
                         "land here every --checkpoint-every rounds; "
                         "rerunning with the same dir resumes from the "
                         "latest one")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def _fit_resumable(model, bins, label, args):
    """Round-by-round fit with ``CheckpointManager``: rerunning with the
    same ``--checkpoint-dir`` resumes at the latest step.  Returns
    (ensemble, margin, seconds, rounds this run trained)."""
    from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                       host_array)
    from dmlc_core_tpu_torch.models.gbdt import _stack_trees
    from dmlc_core_tpu_torch.utils.timer import get_time

    mgr = CheckpointManager(args.checkpoint_dir, keep=3)
    latest = mgr.latest_step()
    dev = model.device
    if latest is None:
        start, trees = 0, []
        margin = model._base_margin(bins.shape[0])
    else:
        state = {k[2:-2]: v for k, v in mgr.restore(latest).items()}
        start = int(state["round"])
        margin = torch.from_numpy(np.array(state["margin"],
                                           np.float32)).to(dev)
        trees = []
        for i in range(start):
            arity = len([k for k in state if k.startswith(f"t{i}_")])
            trees.append(tuple(torch.from_numpy(np.array(state[f"t{i}_{j}"]))
                               .to(dev) for j in range(arity)))
        print(f"resuming from checkpoint step {latest} "
              f"({start}/{args.rounds} rounds done)")
    weight = torch.ones(bins.shape[0], dtype=torch.float32, device=dev)
    t0 = get_time()
    for r in range(start, args.rounds):
        margin, tree = model.boost_round(margin, bins, label, weight,
                                         round_index=r)
        trees.append(tree)
        if (r + 1) % args.checkpoint_every == 0 and (r + 1) < args.rounds:
            payload = {"round": np.int64(r + 1),
                       "margin": host_array(margin)}
            for i, t in enumerate(trees):
                for j, arr in enumerate(t):
                    payload[f"t{i}_{j}"] = host_array(arr)
            mgr.save(r + 1, payload)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mgr.wait_until_finished()
    secs = get_time() - t0
    ensemble = _stack_trees(trees)
    # only the rounds this run trained: a resumed run must not claim the
    # skipped rounds' throughput
    return ensemble, margin, secs, args.rounds - start


def _fit_distributed(model, bins, label, collective):
    """One global data-parallel fit across the worker world (the
    reference's ``_fit_distributed``): every rank holds the same ensemble.

    Shards cut by bytes differ in rows, so every rank pads to the largest
    row count with weight-0 rows, inert in the histograms.  The padded
    layout (rank r's rows at ``r * n_max``) is the reference's global
    array, so a sampled fit draws the reference's bits; the reference
    rounds ``n_max`` up to its local device count, which is 1 for a
    process with one device, as every rank here is.  Returns (ensemble,
    margin of this rank's rows, acc, secs, global rows); acc and global
    rows come from all-reduced hit and weight sums, secs is the slowest
    rank's."""
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh
    from dmlc_core_tpu_torch.utils.timer import device_time

    n_local, nf = bins.shape
    n_max = int(collective.allreduce(np.asarray([n_local]), op="max")[0])
    pad = n_max - n_local
    dev = bins.device
    weight = torch.ones(n_max, dtype=torch.float32, device=dev)
    if pad:
        bins = torch.cat([bins, bins.new_zeros((pad, nf))])
        label = torch.cat([label, label.new_zeros(pad)])
        weight[n_local:] = 0.0
    with make_mesh():
        model.fit_binned(bins, label, weight=weight)   # warm-up
        (ensemble, margin), secs = device_time(model.fit_binned, bins, label,
                                               weight=weight)
    if model.param.objective == "softmax":
        hit = (margin.argmax(1) == label).float()
    else:
        hit = ((margin > 0).float() == label).float()
    sums = collective.allreduce(np.asarray(
        [(hit * weight).sum().item(), weight.sum().item()], np.float64))
    secs = float(collective.allreduce(np.asarray([secs]), op="max")[0])
    # the weight sum is the global real row count (the pads weigh 0)
    return (ensemble, margin[:n_local], float(sums[0] / sums[1]), secs,
            int(round(sums[1])))


def _load_rows(uri: str, part: int, nparts: int, num_feature: int,
               fill: float, meter=None):
    """Parse ``uri``'s share into dense batches, metering the bytes read;
    returns the batches and their real row count."""
    from dmlc_core_tpu_torch.bridge.batching import dense_batches
    from dmlc_core_tpu_torch.data.factory import create_parser

    parser = create_parser(uri, part, nparts, type="auto")
    batches, seen = [], 0
    try:
        for batch in dense_batches(parser, BATCH_ROWS, num_feature,
                                   fill_value=fill):
            batches.append(batch)
            read = parser.bytes_read()
            if meter is not None:
                meter.add(read - seen, nrows=batch.num_rows)
            seen = read
    finally:
        parser.close()
    return batches, sum(b.num_rows for b in batches)


def _to_device(batches, n: int, binner, num_feature: int, device):
    """Bin the batches on the host and feed them through
    ``DeviceFeedLoader`` into one ``[n, F]`` wire tensor and its labels."""
    from dmlc_core_tpu_torch.bridge.loader import DeviceFeedLoader

    wire = torch.from_numpy(np.empty(0, binner.dtype)).dtype
    bins = torch.empty((n, num_feature), dtype=wire, device=device)
    label = torch.empty(n, dtype=torch.float32, device=device)
    row = 0
    for b in DeviceFeedLoader(lambda: map(binner.transform_batch, batches),
                              device=device):
        k = b.num_rows
        bins[row:row + k] = b.bins[:k]
        label[row:row + k] = b.label[:k]
        row += k
    return bins, label


def main(argv: Optional[List[str]] = None):
    """Train and print the ingest and ``trained ...`` lines; returns the
    ensemble and the final training margin."""
    ap = _parser()
    args = ap.parse_args(argv)

    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.bridge.checkpoint import save_checkpoint
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.parallel.mesh import local_shard_info
    from dmlc_core_tpu_torch.utils.device import worker_device
    from dmlc_core_tpu_torch.utils.profiler import ThroughputMeter
    from dmlc_core_tpu_torch.utils.timer import device_time

    # under a tracker launch the worker world shows only after init; gloo,
    # so that ranks may share one card (NCCL refuses two ranks on one)
    collective.init({"backend": "gloo"})
    part, nparts = local_shard_info()
    if nparts > 1 and (args.eval_data or args.checkpoint_dir):
        # one GLOBAL model across the worker world; eval/resume flows are
        # single-host features: error, never silently train per-shard
        # models
        collective.finalize()
        ap.error("--eval-data/--checkpoint-dir are single-host flows; "
                 "under a multi-worker launch the fit is one global "
                 "data-parallel program")
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
    model = GBDT(param, num_feature=args.num_feature,
                 device=worker_device(args.device))

    fill = np.nan if args.handle_missing else 0.0
    meter = ThroughputMeter("ingest")
    batches, n = _load_rows(args.data, part, nparts, args.num_feature, fill,
                            meter)
    print(meter.summary())
    if n == 0:
        ap.error(f"no rows in {args.data!r}")

    sample, have = [], 0
    for b in batches:
        if have >= SAMPLE_ROWS:
            break
        sample.append(b.x[:b.num_rows].numpy())
        have += b.num_rows
    # under a multi-worker launch the shards' quantile summaries merge, so
    # all ranks bin identically; count=n weights this shard by its size
    model.make_bins(np.concatenate(sample)[:SAMPLE_ROWS],
                    comm=collective if nparts > 1 else None, count=n)
    binner = HostBinner(model.boundaries, args.num_bins,
                        handle_missing=args.handle_missing)
    bins, label = _to_device(batches, n, binner, args.num_feature,
                             model.device)
    del batches

    rounds_run = args.rounds
    if nparts > 1:
        ensemble, margin, acc, secs, global_rows = _fit_distributed(
            model, bins, label, collective)
        rows_per_sec = global_rows * rounds_run / secs
        print(f"trained {rounds_run} rounds on {global_rows} rows over "
              f"{nparts} workers in {secs:.2f}s ({rows_per_sec:,.0f} "
              f"rows/sec), train acc {acc:.4f}")
        if args.checkpoint and part == 0:
            save_checkpoint(args.checkpoint, ensemble._asdict())
            print(f"checkpoint written to {args.checkpoint}")
        collective.finalize()
        return ensemble, margin
    if args.checkpoint_dir:
        if args.eval_data or args.early_stopping_rounds:
            ap.error("--checkpoint-dir cannot be combined with --eval-data/"
                     "--early-stopping-rounds (the resumable loop does not "
                     "track eval curves yet)")
        ensemble, margin, secs, rounds_run = _fit_resumable(
            model, bins, label, args)
    elif args.eval_data:
        ev_batches, ev_n = _load_rows(args.eval_data, 0, 1, args.num_feature,
                                      fill)
        ev_bins, ev_label = _to_device(ev_batches, ev_n, binner,
                                       args.num_feature, model.device)

        def fit():
            return model.fit_with_eval(
                bins, label, ev_bins, ev_label,
                early_stopping_rounds=args.early_stopping_rounds)

        fit()                          # warm-up: kernel build and caches
        (ensemble, history), secs = device_time(fit)
        rounds_run = len(history)
        print(f"eval: first {history[0]['eval_loss']:.5f} -> "
              f"last {history[-1]['eval_loss']:.5f} "
              f"({ensemble.num_trees} trees kept)")
        margin = model.predict_margin(ensemble, bins)
    else:
        model.fit_binned(bins, label)  # warm-up: kernel build and caches
        (ensemble, margin), secs = device_time(model.fit_binned, bins, label)
    if args.objective == "softmax":
        acc = (margin.argmax(1) == label).float().mean().item()
    else:
        acc = ((margin > 0).float() == label).float().mean().item()
    rows_per_sec = n * rounds_run / secs
    print(f"trained {rounds_run} rounds on {n} rows in {secs:.2f}s "
          f"({rows_per_sec:,.0f} rows/sec/chip), train acc {acc:.4f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, ensemble._asdict())
        print(f"checkpoint written to {args.checkpoint}")
    collective.finalize()
    return ensemble, margin


if __name__ == "__main__":
    main()
