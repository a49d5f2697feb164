"""Logistic regression over libsvm data, on the card.

The port's counterpart of ``examples/train_logreg.py``: libsvm text ->
InputSplit -> RowBlock -> ``MeshBatchLoader`` batches on the device ->
SGD steps of ``LinearModel.train_step``, with the same flags plus
``--device``::

    python -m dmlc_core_tpu_torch.examples.train_logreg \\
        --data train.libsvm --num-feature 128 [--form dense|sparse] \\
        [--checkpoint '/tmp/ckpt-{version}.bin']

``--checkpoint`` is rabit-style restart recovery: every epoch ends in
``collective.checkpoint`` (version N = N epochs done), and a fresh run
discovers the latest version with ``collective.load_checkpoint`` and
resumes after it.  The files are the JAX example's, so either package
resumes the other's.  ``--device`` defaults to ``cuda``; pass ``--device
cpu`` to run the plain versions on the CPU.

Under a launch of several workers (``python -m
dmlc_core_tpu_torch.tracker.submit --cluster local --num-workers N --
python -m dmlc_core_tpu_torch.examples.train_logreg ...``) every rank
reads its byte-range shard and stages ``batch_size / N`` rows a step; the
steps run under a ``data`` mesh over all ranks, so each one all-reduces
the gradient sums and every rank holds the same params and prints the
global loss.  Shards cut by bytes may yield different batch counts under
``drop_remainder``; the ranks then fall out of step, and the run fails
when the collective times out (``DMLC_COLLECTIVE_TIMEOUT``), as the
reference's does (ROADMAP.md §3).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.examples.train_logreg")
    ap.add_argument("--data", required=True,
                    help="libsvm URI (supports ;-lists, ?format=)")
    ap.add_argument("--num-feature", type=int, required=True)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--learning-rate", type=float, default=0.5)
    ap.add_argument("--form", choices=["dense", "sparse"], default="sparse")
    ap.add_argument("--checkpoint", default="",
                    help="URI template, e.g. /tmp/ckpt-{version}.bin")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None):
    """Train; returns (params, [loss of each epoch this run trained])."""
    ap = _parser()
    args = ap.parse_args(argv)

    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.loader import MeshBatchLoader
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam
    from dmlc_core_tpu_torch.parallel.mesh import local_shard_info, make_mesh
    from dmlc_core_tpu_torch.utils.device import worker_device
    from dmlc_core_tpu_torch.utils.profiler import ThroughputMeter

    # gloo, so that ranks may share one card (NCCL refuses two on one)
    collective.init({"backend": "gloo"})
    part, nparts = local_shard_info()
    collective.tracker_print(f"starting logreg: {nparts} process(es)")
    # resolves the device first: no card and no --device cpu raises here
    model = LinearModel(LinearParam(num_feature=args.num_feature,
                                    learning_rate=args.learning_rate),
                        device=worker_device(args.device))
    parser = create_parser(args.data, part, nparts, type="auto")
    mesh = make_mesh()
    loader = MeshBatchLoader(
        parser, mesh, form=args.form,
        global_batch_size=args.batch_size, num_feature=args.num_feature,
        nnz_bucket=None if args.form == "dense" else args.batch_size * 64,
        device=model.device)
    params = model.init_params()
    start_epoch = 0
    if args.checkpoint:
        restored = collective.load_checkpoint(args.checkpoint,
                                              template=params)
        if restored is not None:
            params = {k: torch.from_numpy(np.array(v)).to(model.device)
                      for k, v in restored.items()}
            start_epoch = collective.version_number()
            collective.tracker_print(
                f"resuming from checkpoint version {start_epoch}")
    meter = ThroughputMeter("train")
    loss = None
    losses = []
    for epoch in range(start_epoch, args.epochs):
        if epoch:
            loader.before_first()
        # under the mesh each step is data-parallel over the ranks
        with mesh:
            for batch in loader:
                params, loss = model.train_step(params, batch)
                meter.add(0, nrows=batch.label.shape[0])
        losses.append(float(loss))
        collective.tracker_print(f"epoch {epoch}: loss={losses[-1]:.5f} "
                                 f"({meter.rows_per_sec:.0f} rows/s)")
        if args.checkpoint:
            collective.checkpoint(params, args.checkpoint)
    collective.tracker_print(meter.summary())
    loader.close()
    collective.finalize()
    return params, losses


if __name__ == "__main__":
    main()
