#!/usr/bin/env python3
"""Time the histogram kernels of the port found at ROOT, so that two
checkouts can be compared on one card.

    python3 dmlc_core_tpu_torch/tools/hist_times.py [--root ROOT] [--tag T]
        [--levels]

ROOT (the checkout this file lies in by default) must hold
``dmlc_core_tpu_torch``; its kernels are built into ROOT/build.  Times are
CUDA-event milliseconds per call (10 calls after 2 warm-up calls); the
last line is the card's name and power limit.

By default, at chip_smoke.py's phase-3 shape (2,000,000 rows x 28 uint8
features x 256 bins): K1 (``hist_matmul_cuda``) at n = 1 and 32 nodes (M
= 16 and 64 weight rows), K2 (``grad_hist_cuda``) at n = 1, 32 and 256,
and K3 (``grad_hist_fused_cuda``) at n = 1, 8, 16, 32 and 256.

With ``--levels``, K3 level by level at the training cells' shapes,
10,000,000 x 28 and 400,000 x 2,000 uint8 features at 256 bins: one
depth-8 tree is grown on seeded data (logistic gradients of a nonlinear
label), each level's ids recorded, and per level it prints the built
nodes, the share of rows they hold, the dense launch (every row read),
the row partition alone, the listed launch alone and the two together.
Compare two checkouts in turns (A, B, B, A) on one card, in one run.
"""

import argparse
import os
import subprocess
import sys


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def kernels(report, hist_cuda, torch, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = 2_000_000, 28, 256
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    grad = torch.randn(B, device=dev, generator=gen)
    hess = torch.rand(B, device=dev, generator=gen)
    for n in (1, 8, 16, 32, 256):
        node = torch.randint(-1, n, (B,), device=dev, generator=gen,
                             dtype=torch.int32)
        args_ = (bins, node, grad, hess, n, nb)
        if n in (1, 32, 256):
            if hist_cuda.hist_node_block(n, F, nb) == n:
                w = hist_cuda.node_weights(node, grad, hess, n)
                report(f"K1 n={n} M={w.shape[0]}",
                       lambda: hist_cuda.hist_matmul_cuda(w, bins, nb))
                del w
            report(f"K2 n={n}", lambda: hist_cuda.grad_hist_cuda(*args_))
        report(f"K3 n={n}", lambda: hist_cuda.grad_hist_fused_cuda(*args_))
        del node


def _tree_levels(torch, dev, rows, features, seed):
    """Bins, g, h and each level's ids (built nodes' parent ids, -1
    elsewhere) of one depth-8 tree grown on seeded data."""
    from dmlc_core_tpu_torch.models import gbdt

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, features, device=dev, generator=gen)
    k = min(features, 8)
    y = ((x[:, :k].sum(1) + torch.sin(3 * x[:, 0]) * x[:, 1]
          + 0.5 * torch.randn(rows, device=dev, generator=gen)) > 0)
    model = gbdt.GBDT(gbdt.GBDTParam(max_depth=8, num_bins=256,
                                     num_boost_round=1), features)
    model.make_bins(x[:100_000].cpu().numpy())
    bins = model.bin_features(x).to(torch.uint8)
    del x
    p = torch.full((rows,), 0.5, device=dev)
    g = p - y.to(torch.float32)
    h = p * (1 - p)
    levels = []
    real = gbdt.grad_histogram

    def record(bins_, node, g_, h_, built, *args, **kw):
        levels.append((node.to(torch.int32).clone(), built))
        return real(bins_, node, g_, h_, built, *args, **kw)

    gbdt.grad_histogram = record
    try:
        gbdt._build_tree(bins, g, h, 8, 256, 1.0, 1.0, 0.1, method="auto")
    finally:
        gbdt.grad_histogram = real
    return bins, g, h, levels


def per_level(report, hist_cuda, torch, dev, tag):
    for rows, features in ((10_000_000, 28), (400_000, 2000)):
        bins, g, h, levels = _tree_levels(torch, dev, rows, features, 0)
        sums = dict(dense=0.0, partition=0.0, listed=0.0, both=0.0)
        for depth, (ids, built) in enumerate(levels):
            share = ((ids >= 0) & (ids < built)).float().mean().item()
            name = f"{rows}x{features} depth={depth} built={built}"
            print(f"[{tag}] {name} share={share:.4f}", flush=True)
            sums["dense"] += report(
                f"{name} K3 dense", lambda: hist_cuda.grad_hist_fused_cuda(
                    bins, ids, g, h, built, 256))
            if depth == 0:
                continue
            part = hist_cuda.row_partition(ids, built)
            sums["partition"] += report(
                f"{name} partition",
                lambda: hist_cuda.row_partition(ids, built))
            sums["listed"] += report(
                f"{name} K3 listed", lambda: hist_cuda.grad_hist_fused_cuda(
                    bins, ids, g, h, built, 256, rows=part[0],
                    offsets=part[1]))

            def both():
                r, o = hist_cuda.row_partition(ids, built)
                return hist_cuda.grad_hist_fused_cuda(bins, ids, g, h, built,
                                                      256, rows=r, offsets=o)
            sums["both"] += report(f"{name} partition+K3 listed", both)
            del part
        print(f"[{tag}] {rows}x{features} sums: "
              + " ".join(f"{k}={v:.3f}" for k, v in sums.items())
              + " (dense over every level; the others below the root)",
              flush=True)
        del bins, g, h, levels
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--levels", action="store_true",
                    help="K3 per tree level at the training cells' shapes")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    if not hist_cuda.__file__.startswith(root):
        raise SystemExit(f"imported {hist_cuda.__file__}, not from {root}")
    tag = args.tag or root
    dev = torch.device("cuda")

    def report(name, fn):
        ms = cuda_event_ms(fn, iters=10, warmup=2)
        print(f"[{tag}] {name} ms={ms:.3f}", flush=True)
        return ms

    if args.levels:
        per_level(report, hist_cuda, torch, dev, tag)
    else:
        kernels(report, hist_cuda, torch, dev)
    print(f"[{tag}] {_card()}")


if __name__ == "__main__":
    main()
