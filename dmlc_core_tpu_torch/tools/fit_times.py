#!/usr/bin/env python3
"""Time chip_smoke.py's phase-4 fit of the port found at ROOT, per histogram
method, so that two checkouts can be compared on one card.

    python3 dmlc_core_tpu_torch/tools/fit_times.py [--root ROOT] [--tag T]
        [--methods auto,pallas_fused,scatter] [--repeat 3]

ROOT (the checkout this file lies in by default) must hold
``dmlc_core_tpu_torch`` and ``chip_smoke.py``; its kernels are built into
ROOT/build.  The fit is ``fit_binned`` on 2,000,000 HIGGS-shaped rows on
the uint8 wire, 28 features, 256 bins, depth 6, 10 rounds, learning rate
0.3.  For each method it makes one warm-up fit, then prints the seconds of
``--repeat`` fits (host clock, each ending in a synchronise) and whether
they all grew the same bits, then the card's name and power limit.
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
    ap.add_argument("--methods", default="auto,pallas_fused,scatter")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from chip_smoke import make_higgs_like
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models import gbdt
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.utils.timer import device_time

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    if not gbdt.__file__.startswith(root):
        raise SystemExit(f"imported {gbdt.__file__}, not from {root}")
    tag = args.tag or root
    x, y = make_higgs_like(2_000_000, 28)
    param = dict(num_boost_round=10, max_depth=6, num_bins=256,
                 learning_rate=0.3)
    probe = GBDT(GBDTParam(**param), num_feature=28)
    probe.make_bins(x[:50_000])
    dev = torch.device("cuda")
    bins = torch.from_numpy(HostBinner(probe.boundaries, 256).transform(x)
                            ).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    for method in args.methods.split(","):
        model = GBDT(GBDTParam(hist_method=method, **param), num_feature=28)
        model.set_boundaries(probe.boundaries)
        (first, _), _ = device_time(model.fit_binned, bins, y_t)  # warm-up
        secs, same = [], True
        for _ in range(args.repeat):
            (ens, _), sec = device_time(model.fit_binned, bins, y_t)
            secs.append(sec)
            same = same and all(torch.equal(a, b)
                                for a, b in zip(first, ens))
        print(f"[{tag}] fit {method} s=" + " ".join(f"{s:.4f}" for s in secs)
              + f" bitwise_repeat={same}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[{tag}] {card}")


if __name__ == "__main__":
    main()
