#!/usr/bin/env python3
"""Where a single-card GBDT fit spends its time on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 dmlc_core_tpu_torch/tools/fit_profile.py [--rows N]

Fits chip_smoke.py's phase-4 model (HIGGS-shaped rows, 28 features, 256
bins, depth 6, 10 rounds, learning rate 0.3) through ``hist_method="auto"``
(K2 -> K1) and ``"pallas_fused"`` (K3): one warm-up fit, then one fit under
``torch.profiler``.  For each it prints the fit's wall time, the device
time summed over all kernels and copies, the device's idle share (1 -
device time / wall time; one stream, so kernels do not overlap), and the
kernels that take the most device time, then the card's name and power
limit.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_higgs_like
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    x, y = make_higgs_like(args.rows, 28)
    param = dict(num_boost_round=10, max_depth=6, num_bins=256,
                 learning_rate=0.3)
    probe = GBDT(GBDTParam(**param), num_feature=28)
    probe.make_bins(x[:50_000])
    dev = torch.device("cuda")
    bins = torch.from_numpy(HostBinner(probe.boundaries, 256).transform(x)
                            ).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    for method in ("auto", "pallas_fused"):
        model = GBDT(GBDTParam(hist_method=method, **param), num_feature=28)
        model.set_boundaries(probe.boundaries)
        model.fit_binned(bins, y_t)                   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            model.fit_binned(bins, y_t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        # device-side events only (kernels, copies, sets): an operator's
        # own entry would count its kernels a second time
        rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
        if not rows:
            raise SystemExit("the profiler recorded no device time")
        device_s = sum(r[1] for r in rows) / 1e6
        print(f"{method}: fit {wall:.3f} s under the profiler, device time "
              f"{device_s:.3f} s, idle share {1 - device_s / wall:.3f}",
              flush=True)
        for key, us, count in sorted(rows, key=lambda r: -r[1])[:args.top]:
            print(f"  {us / 1e3:9.3f} ms  {count:5d} calls  {key[:90]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
