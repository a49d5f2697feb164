#!/usr/bin/env python3
"""Time the histogram kernels of the port found at ROOT, at chip_smoke.py's
phase-3 shape, so that two checkouts can be compared on one card.

    python3 dmlc_core_tpu_torch/tools/hist_times.py [--root ROOT] [--tag T]

ROOT (the checkout this file lies in by default) must hold
``dmlc_core_tpu_torch``; its kernels are built into ROOT/build.  At
2,000,000 rows x 28 uint8 features x 256 bins it prints one line per
measurement: K1 (``hist_matmul_cuda``) at n = 1 and 32 nodes (M = 16 and
64 weight rows), K2 (``grad_hist_cuda``) at n = 1, 32 and 256, and K3
(``grad_hist_fused_cuda``) at n = 1, 8, 16, 32 and 256, in CUDA-event
milliseconds per call (10 calls after 2 warm-up calls), then the card's
name and power limit.
Compare two checkouts in turns (A, B, B, A) on one card, in one run.
"""

import argparse
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="")
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
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = 2_000_000, 28, 256
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    grad = torch.randn(B, device=dev, generator=gen)
    hess = torch.rand(B, device=dev, generator=gen)

    def report(name, fn):
        ms = cuda_event_ms(fn, iters=10, warmup=2)
        print(f"[{tag}] {name} ms={ms:.3f}", flush=True)

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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[{tag}] {card}")


if __name__ == "__main__":
    main()
