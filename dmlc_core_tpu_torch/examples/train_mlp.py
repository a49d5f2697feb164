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
either package resumes the other's checkpoints.  ``--device`` defaults
to ``cuda``; pass ``--device cpu`` to run the plain versions on the CPU.

Under a launch of N workers the steps run under a ``{"data": N / m,
"model": m}`` mesh (``--model-parallel m``, default 1).  The ranks of a
model line read the same byte-range shard (part = their ``data``
coordinate, of ``N / m`` parts) and stage ``batch_size * m / N`` rows a
step; with m > 1 they hold column blocks of the middle layers
(``MLP(model_axis="model")``).  The gradients are all-reduced over the
data line before Adam, so every rank of a model line holds the same
blocks and every data line the same params.  Rank 0 writes
``--checkpoint-dir`` after gathering its model line's blocks: the
checkpoint is the full tree, which either package, and any
``--model-parallel``, resumes (a resume cuts the blocks again).  Every
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
                    help="mesh width of the 'model' axis for tp layers")
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


def _gathered(model, params, opt_state):
    """The full ``(params, opt_state)`` trees from the rank's blocks
    (collective over the model line)."""
    from dmlc_core_tpu_torch.models.mlp import AdamState

    return model.gather_params(params), AdamState(
        count=opt_state.count, mu=model.gather_params(opt_state.mu),
        nu=model.gather_params(opt_state.nu))


def _sharded(model, params, opt_state):
    """The rank's blocks of full ``(params, opt_state)`` trees."""
    from dmlc_core_tpu_torch.models.mlp import AdamState

    return model.shard_params(params), AdamState(
        count=opt_state.count, mu=model.shard_params(opt_state.mu),
        nu=model.shard_params(opt_state.nu))


def main(argv: Optional[List[str]] = None):
    """Train; returns (params, opt_state, [loss of each epoch this run
    trained]), the rank's blocks with ``--model-parallel`` > 1."""
    ap = _parser()
    args = ap.parse_args(argv)

    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.loader import MeshBatchLoader
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
    from dmlc_core_tpu_torch.parallel.mesh import local_shard_info, make_mesh
    from dmlc_core_tpu_torch.utils.device import worker_device
    from dmlc_core_tpu_torch.utils.profiler import ThroughputMeter

    # gloo, so that ranks may share one card (NCCL refuses two on one)
    collective.init({"backend": "gloo"})
    world = collective.get_world_size()
    mp = max(1, args.model_parallel)
    if world % mp:
        raise SystemExit(f"--model-parallel {mp} does not divide {world} "
                         f"ranks")
    mesh = make_mesh({"data": world // mp, "model": mp} if mp > 1
                     else {"data": world})
    # the ranks of a model line read the same rows: the part of their data
    # coordinate (rank // mp on the row-major mesh)
    part, nparts = local_shard_info()
    part, nparts = part // mp, nparts // mp
    param = MLPParam(num_feature=args.num_feature, hidden=args.hidden,
                     learning_rate=args.learning_rate)
    # resolves the device first: no card and no --device cpu raises here
    model = MLP(param, model_axis="model" if mp > 1 else None,
                device=worker_device(args.device), mesh=mesh)
    params = model.init_params()
    opt_state = model.init_optimizer(params)

    mgr = None
    start_epoch = 0
    if args.checkpoint_dir:
        from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        latest = mgr.latest_step()
        if world > 1:
            # rank 0 is the writer: every rank must see ITS view of the
            # store agree with rank 0's, otherwise --checkpoint-dir is not
            # shared storage and ranks would resume at different epochs
            # (desynchronized collectives deadlock). Fail loudly instead.
            mine = -1 if latest is None else latest
            agreed = int(collective.broadcast(np.int64(mine), root=0))
            if agreed != mine:
                raise SystemExit(
                    f"--checkpoint-dir must be shared storage: rank "
                    f"{collective.get_rank()} sees step {mine} but rank 0 "
                    f"sees {agreed}")
        if latest is not None:
            # template restore of the full trees into the reference's
            # optimizer layout, then the rank's blocks
            tmpl = MLP(param, device=model.device).init_params()
            params, (opt_state, _) = _on_device(mgr.restore(
                latest, template=(tmpl, (model.init_optimizer(tmpl), ()))),
                model.device)
            params, opt_state = _sharded(model, params, opt_state)
            start_epoch = latest
            collective.tracker_print(
                f"resuming from checkpoint epoch {latest}")

    parser = create_parser(args.data, part, nparts, type="auto")
    meter = ThroughputMeter("train")
    loader = MeshBatchLoader(parser, mesh, form="dense",
                             global_batch_size=args.batch_size,
                             num_feature=args.num_feature,
                             device=model.device)
    losses = []
    for epoch in range(start_epoch, args.epochs):
        loss = None
        # under the mesh each step is data-parallel over the data line
        with mesh:
            for batch in loader:
                params, opt_state, loss = model.train_step(params, opt_state,
                                                           batch)
                meter.add(0, nrows=batch.label.shape[0])
        loader.before_first()
        if loss is not None:
            losses.append(float(loss))
            collective.tracker_print(f"epoch {epoch}: loss={losses[-1]:.5f}")
        if mgr is not None and (epoch + 1) < args.epochs:
            full = _gathered(model, params, opt_state)   # every rank
            if collective.get_rank() == 0:
                mgr.save(epoch + 1, (full[0], (full[1], ())))
    if mgr is not None:
        mgr.wait_until_finished()
    loader.close()
    print(meter.summary())
    collective.finalize()
    return params, opt_state, losses


if __name__ == "__main__":
    main()
