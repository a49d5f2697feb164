#!/usr/bin/env python3
"""Where one GBDT scoring call spends its time on the card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 dmlc_core_tpu_torch/tools/serve_profile.py [--rows N]

Fits chip_smoke.py's phase-4 model shape (HIGGS-shaped rows, 28 features,
256 bins, depth 6, 10 rounds) on ``--rows`` rows, wraps it in the serving
runtime (``GBDTRuntime``: host binning to uint8, the copy to the card,
``predict``, the scores back to the host), and for batches of 1, 64, 4,096
and 65,536 rows prints the median wall time of one ``predict`` call, then
the same calls under ``torch.profiler``: CUDA kernels launched per call,
device time per call, and the device's idle share (1 - device time / wall
time), with the three kernels that take the most device time.  Last, the
card's name and power limit.
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
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_higgs_like
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.serve import GBDTRuntime

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    x, y = make_higgs_like(args.rows + 65_536, 28)
    model = GBDT(GBDTParam(num_boost_round=10, max_depth=6, num_bins=256,
                           learning_rate=0.3), num_feature=28)
    model.make_bins(x[:50_000])
    ens, _ = model.fit_binned(model.bin_features(x[:args.rows]),
                              y[:args.rows])
    runtime = GBDTRuntime(model, ens)
    held = x[args.rows:]
    for n in (1, 64, 4096, 65_536):
        rows = np.ascontiguousarray(held[:n])
        runtime.predict(rows)                         # warm-up
        times = []
        for _ in range(args.reps):
            start = time.perf_counter()
            runtime.predict(rows)
            times.append(time.perf_counter() - start)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(args.reps):
                runtime.predict(rows)
            wall = time.perf_counter() - start
        rows_ = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA") and _device_us(e) > 0]
        if not rows_:
            raise SystemExit("the profiler recorded no device time")
        device_s = sum(r[1] for r in rows_) / 1e6
        launches = sum(r[2] for r in rows_) / args.reps
        print(f"{n:6d} rows: predict median {1e3 * np.median(times):.3f} ms "
              f"({n / np.median(times):,.0f} rows/s); under the profiler "
              f"{launches:.0f} device ops per call (kernels and copies), "
              f"device time {1e3 * device_s / args.reps:.3f} ms per call, "
              f"idle share {1 - device_s / wall:.3f}", flush=True)
        for key, us, count in sorted(rows_, key=lambda r: -r[1])[:3]:
            print(f"    {us / 1e3 / args.reps:8.3f} ms  "
                  f"{count / args.reps:5.0f} per call  {key[:80]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
