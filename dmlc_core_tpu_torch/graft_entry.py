"""Entry points.

Counterparts of the repository's ``__graft_entry__.py``:

- :func:`entry`: a forward step of the flagship model, hist-GBDT ensemble
  prediction over binned features, on a tiny seeded ensemble (3 trees of
  depth 3 over 8 features and 16 bins) and 64 rows of bins, drawn with the
  same ``RandomState`` calls, so both packages score the same trees on the
  same rows;
- :func:`dryrun_multichip`: the full sharded training step on a mesh of
  ``n`` ranks at tiny shapes, section by section as the reference runs it
  (the GBDT round on data x model with K4, the sparsity-aware and 3-class
  fits, the sparse logistic step, the tensor-parallel MLP step, the hybrid
  mesh at n >= 8, ring and Ulysses attention with the ring's gradient).
  Called outside a job it starts ``n`` ranks through the port's launcher
  (``tracker.submit --cluster local``), over gloo, so that they may share
  one card; inside a job of ``n`` workers it runs this rank's part.

    python -c "from dmlc_core_tpu_torch import graft_entry as g; \\
        g.dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["entry", "dryrun_multichip"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_ensemble(num_trees=3, max_depth=3, num_feature=8, num_bins=16,
                   seed=0, device=None) -> TreeEnsemble:
    rng = np.random.RandomState(seed)
    n_internal = 2 ** max_depth - 1
    n_leaf = 2 ** max_depth
    arrays = (
        rng.randint(-1, num_feature, (num_trees, n_internal)).astype(np.int32),
        rng.randint(0, num_bins, (num_trees, n_internal)).astype(np.int32),
        rng.randn(num_trees, n_leaf).astype(np.float32),
        np.zeros((num_trees, n_internal), dtype=bool),
    )
    return TreeEnsemble(*(torch.from_numpy(a).to(device) for a in arrays))


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` is the ensemble's
    margin on the example rows, [64] float32, computed on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    max_depth, num_bins, num_feature = 3, 16, 8
    param = GBDTParam(num_boost_round=3, max_depth=max_depth,
                      num_bins=num_bins)
    model = GBDT(param, num_feature=num_feature, device=dev)

    def forward(ensemble, bins):
        return model.predict_margin(ensemble, bins)

    ensemble = _tiny_ensemble(3, max_depth, num_feature, num_bins,
                              device=dev)
    bins = torch.from_numpy(np.random.RandomState(1).randint(
        0, num_bins, (64, num_feature)).astype(np.int32)).to(dev)
    return forward, (ensemble, bins)


def _model_par(n: int) -> int:
    # the reference's choice: 16+ ranks a 4-way model axis, 4+ even ranks
    # a 2-way one
    if n >= 16 and n % 4 == 0:
        return 4
    if n >= 4 and n % 2 == 0:
        return 2
    return 1


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# K4 against its plain versions: the kernel tolerance of chip_smoke.py
K4_RTOL, K4_ATOL = 1e-4, 1e-3


def _check_k4(sharding, bins_full, num_bins: int, dev) -> float:
    """K4 at the dryrun's shapes (its ``model`` axis) on the rows that the
    1-D ``sharding`` gives this rank (node ids, grad and hess drawn from a
    seed, the same on every rank), held against K4's plain version on the
    same rows and against ``grad_hist_ref`` of all rows and columns, which
    shares none of K4's collectives.  These launches check the kernel, so
    its counts are put back.  Returns the max abs error of (G, H); beyond
    the tolerance it raises."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    B, num_nodes = bins_full.shape[0], 4
    rng = np.random.RandomState(1)
    # ids -1 and num_nodes are rows outside the level: they add nothing
    nodes = rng.randint(-1, num_nodes + 1, B)
    full = (bins_full,
            torch.as_tensor(nodes, dtype=torch.int32, device=dev),
            torch.as_tensor(rng.randn(B), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.rand(B), dtype=torch.float32, device=dev))
    saved = dict(hist_cuda.LAUNCHES)
    with sharding as mesh:
        mine = [sharding.shard(t) for t in full]
        got = hist_cuda.grad_hist_sharded_cuda(*mine, num_nodes, num_bins,
                                               mesh, "model")
        launched = (hist_cuda.LAUNCHES["grad_hist_sharded_cuda"]
                    - saved["grad_hist_sharded_cuda"])
        plain = hist_cuda.grad_hist_sharded_ref(*mine, num_nodes, num_bins,
                                                mesh, "model")
    hist_cuda.LAUNCHES.update(saved)
    CHECK(launched == (1 if dev.type == "cuda" else 0),
          f"K4 check: {launched} K4 launches for one call")
    whole = hist_cuda.grad_hist_ref(*full, num_nodes, num_bins)
    err = 0.0
    for want in (plain, whole):
        for a, b in zip(got, want):
            CHECK(torch.allclose(a, b, rtol=K4_RTOL, atol=K4_ATOL),
                  f"K4 on rows over {mesh.row_axes} at {num_bins} bins "
                  f"differs from its plain version by "
                  f"{(a - b).abs().max().item()}")
            err = max(err, (a - b).abs().max().item())
    return err


def dryrun_multichip(n_devices: int, device=None,
                     timeout_s: float = 600.0) -> Dict[str, Any]:
    """One full sharded training step on a mesh of ``n_devices`` ranks
    (data x model), on ``device`` (``cuda`` unless ``device="cpu"``).
    Prints the reference's ``dryrun_multichip OK on {n} devices (...)``
    line and returns rank 0's summary: ``line``, ``k4_launches`` (K4's
    launches over the run, 0 on the CPU, where K4's plain version runs),
    ``k4_max_abs_err`` (K4 at the run's shapes against its plain versions,
    by mesh: ``flat``, and ``hybrid`` at n >= 8) and ``seconds``.  Any
    failed check raises.  Outside a job the ranks are started here and
    must finish within ``timeout_s``."""
    in_job = os.environ.get("DMLC_COORDINATOR_URI") \
        and int(os.environ.get("DMLC_NUM_WORKER", "1")) > 1
    if in_job:
        return _dryrun_rank(n_devices, device)
    resolve_device(device)          # no card and no device="cpu" raises here
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip") as out:
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   DMLC_DRYRUN_OUT=out,
                   PYTHONPATH=_PKG_ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.setdefault("DMLC_COLLECTIVE_TIMEOUT", str(int(timeout_s)))
        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
               "--cluster", "local", "--num-workers", str(n_devices),
               "--env", f"DMLC_COORDINATOR_PORT={_free_port()}", "--",
               sys.executable, "-m", "dmlc_core_tpu_torch.graft_entry",
               "--dryrun", str(n_devices)]
        if device is not None:
            cmd += ["--device", str(device)]
        # a process group of its own, so that a timeout stops the ranks
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            _, err = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired as e:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks "
                               f"did not finish within {timeout_s} s") from e
        path = os.path.join(out, "rank0.json")
        CHECK(proc.returncode == 0 and os.path.exists(path),
              f"dryrun_multichip({n_devices}) failed (exit "
              f"{proc.returncode}):\n{err[-4000:]}")
        with open(path) as f:
            summary = json.load(f)
    print(summary["line"], flush=True)
    return summary


def _dryrun_rank(n: int, device) -> Dict[str, Any]:
    """This rank's part of :func:`dryrun_multichip`, in a job of ``n``
    workers; rank 0 prints the OK line and writes its summary into
    ``$DMLC_DRYRUN_OUT`` when that is set."""
    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.batching import DenseBatch, SparseBatch
    from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.parallel.mesh import (data_sharding,
                                                   make_hybrid_mesh,
                                                   make_mesh)
    from dmlc_core_tpu_torch.parallel.sequence import (reference_attention,
                                                       ring_attention,
                                                       shard_sequence,
                                                       ulysses_attention)
    from dmlc_core_tpu_torch.utils.device import worker_device

    start = time.perf_counter()
    # gloo: the ranks may share one card (NCCL refuses two on one)
    collective.init({"backend": "gloo"})
    CHECK(collective.get_world_size() == n,
          f"dryrun_multichip({n}) inside a job of "
          f"{collective.get_world_size()} workers")
    dev = worker_device(device)
    model_par = _model_par(n)
    mesh = make_mesh({"data": n // model_par, "model": model_par})
    hist_cuda.reset_launches()
    k4_err = {}

    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # --- hist-GBDT boosting round: rows dp-sharded, histogram model-sharded
    B, F, num_bins = 8 * n, 8, 16
    rng = np.random.RandomState(0)
    x = rng.randn(B, F).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    param = GBDTParam(num_boost_round=1, max_depth=3, num_bins=num_bins)
    gbdt = GBDT(param, num_feature=F, model_axis="model", device=dev)
    gbdt.make_bins(x)
    rows1 = data_sharding(mesh, ndim=1)
    rows2 = data_sharding(mesh, ndim=2)
    bins_full = gbdt.bin_features(x)
    with mesh:
        bins = rows2.shard(bins_full)
        label = put(rows1.shard(y))
        weight = torch.ones_like(label)
        margin = torch.zeros_like(label)
        new_margin, _ = gbdt.boost_round(margin, bins, label, weight)
        CHECK(bool(torch.isfinite(new_margin).all()),
              "gbdt round: margin not finite")

        # --- sparsity-aware fit (missing bin + learned defaults) under dp
        x_miss = x.copy()
        x_miss[rng.rand(B, F) < 0.25] = np.nan
        gbdt_m = GBDT(GBDTParam(num_boost_round=1, max_depth=3,
                                num_bins=num_bins, handle_missing=True),
                      num_feature=F, device=dev)
        gbdt_m.make_bins(x_miss)
        bins_m = rows2.shard(gbdt_m.bin_features(x_miss))
        _, margin_m = gbdt_m.fit_binned(bins_m, label)
        CHECK(bool(torch.isfinite(margin_m).all()),
              "sparsity-aware fit: margin not finite")

        # --- multiclass (softmax) fit: K trees/round under the dp sharding
        gbdt_mc = GBDT(GBDTParam(num_boost_round=1, max_depth=2,
                                 num_bins=num_bins, objective="softmax",
                                 num_class=3), num_feature=F, device=dev)
        gbdt_mc.set_boundaries(gbdt.boundaries)
        y_mc = put(rows1.shard(rng.randint(0, 3, B).astype(np.float32)))
        _, margin_mc = gbdt_mc.fit_binned(bins, y_mc)
        CHECK(tuple(margin_mc.shape) == (label.shape[0], 3),
              f"softmax fit: margin shape {tuple(margin_mc.shape)}")
        CHECK(bool(torch.isfinite(margin_mc).all()),
              "softmax fit: margin not finite")

        # --- the same round on the model-sharded kernel (K4) -------------
        # (the reference forces its Pallas kernel in interpret mode here;
        # the port launches K4 on the card, its plain version on the CPU)
        if model_par > 1:
            gbdt_p = GBDT(GBDTParam(num_boost_round=1, max_depth=3,
                                    num_bins=num_bins, hist_method="pallas"),
                          num_feature=F, model_axis="model", device=dev)
            gbdt_p.set_boundaries(gbdt.boundaries)
            plan = gbdt_p._fit_inputs(bins, label, weight)[3]
            CHECK(plan.mesh is not None,
                  f"K4's plan refused {F // model_par} columns a shard at "
                  f"{num_bins} bins (method {plan.method!r})")
            before = hist_cuda.LAUNCHES["grad_hist_sharded_cuda"]
            pm, _ = gbdt_p.boost_round(margin, bins, label, weight)
            CHECK(bool(torch.isfinite(pm).all()),
                  "K4 round: margin not finite")
            if dev.type == "cuda":
                CHECK(hist_cuda.LAUNCHES["grad_hist_sharded_cuda"] > before,
                      "the K4 round launched no K4 on the card")
            k4_err["flat"] = _check_k4(rows1, bins_full, num_bins, dev)

        # --- sparse logistic step, dp-sharded flat-COO batch --------------
        nnz = B * 2
        index = rng.randint(0, F, nnz).astype(np.int32)
        row_id = np.repeat(np.arange(B, dtype=np.int32), 2)
        lo, hi = rows1.block(B)
        mine = slice(2 * lo, 2 * hi)
        batch = SparseBatch(
            value=put(np.ones(2 * (hi - lo), np.float32)),
            index=put(index[mine]),
            row_id=put(row_id[mine] - lo),     # the rank's rows from 0
            label=label, weight=weight)
        linear = LinearModel(LinearParam(num_feature=F, learning_rate=0.1),
                             device=dev)
        _, loss = linear.train_step(linear.init_params(), batch)
        CHECK(bool(torch.isfinite(loss)), "sparse logistic step: loss")

        # --- MLP training step: dp rows x tp hidden layers ----------------
        mlp = MLP(MLPParam(num_feature=F, hidden="16,16", num_class=2),
                  model_axis="model" if model_par > 1 else None, device=dev,
                  mesh=mesh)
        mparams = mlp.init_params()
        mopt = mlp.init_optimizer(mparams)
        dense = DenseBatch(x=put(rows2.shard(x)), label=label, weight=weight)
        _, _, mloss = mlp.train_step(mparams, mopt, dense)
        CHECK(bool(torch.isfinite(mloss)), "tp MLP step: loss not finite")

    # --- hybrid multi-slice mesh: dcn_data x ici_data x model --------------
    hybrid_desc = "skipped (needs >=8 devices, divisible by 2*model_par)"
    if n >= 8 and n % (2 * model_par) == 0:
        dcn = 2
        ici_data = n // (dcn * model_par)
        hmesh = make_hybrid_mesh({"ici_data": ici_data, "model": model_par},
                                 {"dcn_data": dcn})
        gbdt_h = GBDT(param, num_feature=F, model_axis="model", device=dev)
        gbdt_h.set_boundaries(gbdt.boundaries)
        h1 = data_sharding(hmesh, axis=("dcn_data", "ici_data"), ndim=1)
        h2 = data_sharding(hmesh, axis=("dcn_data", "ici_data"), ndim=2)
        with h1:
            hlabel = put(h1.shard(y))
            hm, _ = gbdt_h.boost_round(torch.zeros_like(hlabel),
                                       h2.shard(bins_full), hlabel,
                                       torch.ones_like(hlabel))
        CHECK(bool(torch.isfinite(hm).all()), "hybrid round: margin")
        k4_err["hybrid"] = _check_k4(h1, bins_full, num_bins, dev)
        # the hybrid layout must agree with the flat dp x model mesh: the
        # rank holds the same rows on both
        CHECK(h1.block(B) == rows1.block(B)
              and torch.allclose(hm, new_margin, rtol=0, atol=1e-5),
              "the hybrid mesh's margin differs from the flat mesh's")
        hybrid_desc = (f"dcn_data={dcn} x ici_data={ici_data} x "
                       f"model={model_par}")

    # --- sequence-parallel exact attention: ring AND Ulysses over sp -------
    sp_mesh = make_mesh({"sp": n})
    L, H, D = 4 * n, 2, 8
    q, k, v = (rng.randn(2, L, H, D).astype(np.float32) for _ in range(3))
    tq, tk, tv = (put(a) for a in (q, k, v))

    def mine_of(a):
        return shard_sequence(a, sp_mesh, "sp")

    out = ring_attention(mine_of(tq), mine_of(tk), mine_of(tv), sp_mesh,
                         axis="sp", causal=True)
    ref = reference_attention(tq, tk, tv, causal=True)
    CHECK(torch.allclose(out, mine_of(ref), rtol=0, atol=1e-4),
          "ring attention differs from the reference")

    # Ulysses needs heads % sp == 0: give it sp heads
    Hu = n
    qu, ku, vu = (put(rng.randn(2, L, Hu, D).astype(np.float32))
                  for _ in range(3))
    outu = ulysses_attention(mine_of(qu), mine_of(ku), mine_of(vu), sp_mesh,
                             axis="sp", causal=True)
    refu = reference_attention(qu, ku, vu, causal=True)
    CHECK(torch.allclose(outu, mine_of(refu), rtol=0, atol=1e-4),
          "Ulysses attention differs from the reference")

    # long-context TRAINING: the gradient through the ring's rotations
    # must match full attention's (every rank's loss is its block's)
    a = mine_of(tq).clone().requires_grad_(True)
    (ring_attention(a, mine_of(tk), mine_of(tv), sp_mesh, axis="sp",
                    causal=True) ** 2).sum().backward()
    full = tq.clone().requires_grad_(True)
    (reference_attention(full, tk, tv, causal=True) ** 2).sum().backward()
    CHECK(torch.allclose(a.grad, mine_of(full.grad), rtol=0, atol=1e-4),
          "the ring's q gradient differs from full attention's")

    kernel = ("K4 on the card" if dev.type == "cuda"
              else "K4's plain version on the CPU")
    line = (f"dryrun_multichip OK on {n} devices (mesh data={n // model_par}"
            f" x model={model_par}; gbdt dp+model hist incl. {kernel} + "
            f"sparsity-aware fit, sparse+dense dp steps, tp MLP, sp ring + "
            f"Ulysses attention incl. ring-attention grads; hybrid mesh "
            f"{hybrid_desc})")
    summary = {"line": line, "seconds": time.perf_counter() - start,
               "k4_launches": hist_cuda.LAUNCHES["grad_hist_sharded_cuda"],
               "k4_max_abs_err": k4_err}
    collective.allreduce(np.zeros(1, np.float32))   # every rank passed
    if collective.get_rank() == 0:
        print(line, flush=True)
        out_dir = os.environ.get("DMLC_DRYRUN_OUT")
        if out_dir:
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump(summary, f)
    return summary


def _main(argv) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.graft_entry")
    ap.add_argument("--dryrun", type=int, required=True,
                    help="run this rank's part of dryrun_multichip(N)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from dmlc_core_tpu_torch import collective

    _dryrun_rank(args.dryrun, args.device)
    collective.finalize()


if __name__ == "__main__":
    _main(sys.argv[1:])
