"""MLP training over dense or libsvm data (bf16 matmuls), on the card.

The port's counterpart of ``examples/train_mlp.py``: ``MeshBatchLoader``
dense batches on the device -> Adam steps of ``MLP.train_step``, with the
same flags plus ``--device``::

    python -m dmlc_core_tpu_torch.examples.train_mlp \\
        --data train.libsvm --num-feature 28 [--checkpoint-dir DIR]

``--checkpoint-dir`` saves ``(params, optimizer state)`` after every epoch
but the last through ``CheckpointManager`` (step N = N epochs done); a
rerun with the same directory restores the latest step into the freshly
initialised structure and resumes.  The optimizer state is written in the
reference's layout (optax's ``(ScaleByAdamState, EmptyState)``), so
either package resumes the other's checkpoints.  ``--model-parallel`` > 1
raises: sharding the hidden layers needs more than one card (ROADMAP §1
item 9a).  ``--device`` defaults to ``cuda``; pass ``--device cpu`` to run
the plain versions on the CPU.

Under a launch of several workers every rank reads its byte-range shard
and stages ``batch_size / N`` rows a step; the steps run under a ``data``
mesh over all ranks (the gradients all-reduced before Adam), so every
rank holds the same params.  Rank 0 writes ``--checkpoint-dir``, and every
rank checks that its view of the directory's latest step is rank 0's
(shared storage), exiting otherwise, as the reference does.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.examples.train_mlp")
    ap.add_argument("--data", required=True)
    ap.add_argument("--num-feature", type=int, required=True)
    ap.add_argument("--hidden", default="128,128")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="width of the 'model' mesh axis for the hidden "
                         "layers (only 1 in the port)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="resumable training: epoch-numbered checkpoints "
                         "(params + optimizer state); rerunning with the "
                         "same dir resumes at the latest epoch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _on_device(tree, device):
    """A restored tree's numpy leaves as tensors on ``device``."""
    from dmlc_core_tpu_torch.bridge.checkpoint import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def main(argv: Optional[List[str]] = None):
    """Train; returns (params, opt_state, [loss of each epoch this run
    trained])."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: sharding the hidden "
            f"layers over a model mesh axis needs more than one card and is "
            f"not ported (ROADMAP.md §1 item 9a)")

    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.loader import MeshBatchLoader
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
    from dmlc_core_tpu_torch.parallel.mesh import local_shard_info, make_mesh
    from dmlc_core_tpu_torch.utils.device import worker_device
    from dmlc_core_tpu_torch.utils.profiler import ThroughputMeter

    # gloo, so that ranks may share one card (NCCL refuses two on one)
    collective.init({"backend": "gloo"})
    part, nparts = local_shard_info()
    param = MLPParam(num_feature=args.num_feature, hidden=args.hidden,
                     learning_rate=args.learning_rate)
    # resolves the device first: no card and no --device cpu raises here
    model = MLP(param, device=worker_device(args.device))
    params = model.init_params()
    opt_state = model.init_optimizer(params)

    mgr = None
    start_epoch = 0
    if args.checkpoint_dir:
        from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        latest = mgr.latest_step()
        if nparts > 1:
            # rank 0 is the writer: every rank must see ITS view of the
            # store agree with rank 0's, otherwise --checkpoint-dir is not
            # shared storage and ranks would resume at different epochs
            # (desynchronized collectives deadlock). Fail loudly instead.
            mine = -1 if latest is None else latest
            agreed = int(collective.broadcast(np.int64(mine), root=0))
            if agreed != mine:
                raise SystemExit(
                    f"--checkpoint-dir must be shared storage: rank "
                    f"{part} sees step {mine} but rank 0 sees {agreed}")
        if latest is not None:
            # template restore into the reference's optimizer layout
            params, (opt_state, _) = _on_device(mgr.restore(
                latest, template=(params, (opt_state, ()))), model.device)
            start_epoch = latest
            collective.tracker_print(
                f"resuming from checkpoint epoch {latest}")

    parser = create_parser(args.data, part, nparts, type="auto")
    meter = ThroughputMeter("train")
    mesh = make_mesh()
    loader = MeshBatchLoader(parser, mesh, form="dense",
                             global_batch_size=args.batch_size,
                             num_feature=args.num_feature,
                             device=model.device)
    losses = []
    for epoch in range(start_epoch, args.epochs):
        loss = None
        # under the mesh each step is data-parallel over the ranks
        with mesh:
            for batch in loader:
                params, opt_state, loss = model.train_step(params, opt_state,
                                                           batch)
                meter.add(0, nrows=batch.label.shape[0])
        loader.before_first()
        if loss is not None:
            losses.append(float(loss))
            collective.tracker_print(f"epoch {epoch}: loss={losses[-1]:.5f}")
        if mgr is not None and (epoch + 1) < args.epochs and part == 0:
            mgr.save(epoch + 1, (params, (opt_state, ())))
    if mgr is not None:
        mgr.wait_until_finished()
    loader.close()
    print(meter.summary())
    collective.finalize()
    return params, opt_state, losses


if __name__ == "__main__":
    main()
