#!/usr/bin/env python3
"""Time the traversal kernel behind ``GBDT.predict_margin`` beside its plain
version, on one card.

    python3 dmlc_core_tpu_torch/tools/predict_times.py [--sass]

At ``higgs.score``'s shape (4,194,304 rows x 28 uint8 features, a full
500-tree depth-8 ensemble, 256 bins) and at a few others, each line gives
``predict_margin_cuda`` in CUDA-event milliseconds a call (20 calls after
3 warm-up calls), the plain version ``predict_margin_ref`` run on the same
card tensors (2 calls after 1), whether the two are bitwise equal, the
kernel's bound (rows x trees x depth compares at 67 T/s, or the bins read
and scores written once at 3.35 TB/s, whichever is larger) and the launch
plan, then every other tier of ``predict_cuda.TIERS`` that fits the
shape, forced, with its milliseconds and whether it is bitwise the plain
version too.  Then the card's name and power limit.  ``--sass`` also prints each
traversal kernel's registers and spills (``ptxas -v``) and counts its
shared-memory loads (``LDS``) and generic or global ones (``LD``,
``LDG``) in the SASS.
"""

import argparse
import os
import re
import subprocess
import sys

F32_OPS = 67e12          # f32 operations a second outside the tensor cores
HBM_BYTES = 3.35e12      # device memory bytes a second

SHAPES = [
    # (label, rows, features, depth, trees, classes, bins dtype, missing)
    ("higgs.score", 4_194_304, 28, 8, 500, 1, "uint8", False),
    ("softmax3", 1_048_576, 28, 8, 100, 3, "uint8", False),
    ("missing", 4_194_304, 28, 8, 500, 1, "uint8", True),
    ("int32", 4_194_304, 28, 8, 500, 1, "int32", False),
    ("wide56", 4_194_304, 56, 8, 500, 1, "uint8", False),
    ("criteo67", 4_194_304, 67, 8, 500, 1, "uint8", False),
    ("wide111", 4_194_304, 111, 8, 500, 1, "uint8", False),
    ("epsilon", 400_000, 2000, 8, 500, 1, "uint8", False),
    ("depth6", 4_194_304, 28, 6, 500, 1, "uint8", False),
    ("depth12", 1_048_576, 28, 12, 100, 1, "uint8", False),
    ("serve64", 64, 28, 8, 500, 1, "uint8", False),
]


def _sass(lib_path):
    from dmlc_core_tpu_torch.ops import _build

    if "ptxas" not in _build.BUILD_INFO:     # built by another process
        _build._build()
    name = ""
    for line in str(_build.BUILD_INFO["ptxas"]).splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            name = m.group(1)
        elif "predict" in name and ("registers" in line or "spill" in line):
            print(f"ptxas {name[:60]} {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "predict" not in name:
            continue
        ops = re.findall(r"\b(LDS|LDG|LD)(?:\.[A-Z0-9.]+)?\b", fn)
        counts = {k: ops.count(k) for k in ("LDS", "LDG", "LD")}
        print(f"sass {name[:60]} {counts}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(os.path.dirname(here)))
    import torch

    from dmlc_core_tpu_torch.ops import _build, predict_cuda
    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, B, F, d, T, K, dtype, missing in SHAPES:
        nb = 256
        bins = torch.randint(0, nb, (B, F), device=dev, generator=gen,
                             dtype=torch.int32)
        if dtype == "uint8":
            bins = bins.to(torch.uint8)
        lead = (T, K) if K > 1 else (T,)
        inner = 2 ** d - 1
        trees = (
            torch.randint(0, F, lead + (inner,), device=dev, generator=gen,
                          dtype=torch.int32),
            torch.randint(0, nb - 1, lead + (inner,), device=dev,
                          generator=gen, dtype=torch.int32),
            0.1 * torch.randn(lead + (inner + 1,), device=dev, generator=gen),
            torch.rand(lead + (inner,), device=dev, generator=gen) < 0.5)
        miss = nb - 1 if missing else -1
        run = (lambda: predict_cuda.predict_margin_cuda(*trees, bins, d, miss,
                                                        0.0))
        plain = (lambda: predict_cuda.predict_margin_ref(*trees, bins, d,
                                                         miss, 0.0))
        ms = cuda_event_ms(run, iters=20, warmup=3)
        equal = torch.equal(run(), plain())
        plain_ms = cuda_event_ms(plain, iters=2, warmup=1)
        bound_ms = 1e3 * max(float(B) * T * K * d / F32_OPS,
                             B * (F * bins.element_size() + 4 * K)
                             / HBM_BYTES)
        plan = predict_cuda.predict_plan(F, d, T)
        print(f"{label} rows={B} F={F} depth={d} trees={T} K={K} {dtype} "
              f"missing={missing} kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} "
              f"bound_ms={bound_ms:.4f} rows_per_s={B / ms * 1e3:.4e} "
              f"bitwise={equal} plan={tuple(plan)}",
              flush=True)
        want = plain()
        for budget, bins_smem in predict_cuda.TIERS:
            alt = predict_cuda.tier_plan(budget, bins_smem, F, d, T)
            if alt is None or alt == plan:
                continue
            chosen = predict_cuda.predict_plan
            predict_cuda.predict_plan = lambda *_, alt=alt: alt
            try:
                alt_ms = cuda_event_ms(run, iters=20, warmup=3)
                alt_equal = torch.equal(run(), want)
            finally:
                predict_cuda.predict_plan = chosen
            print(f"{label} tier budget={budget} bins_smem={bins_smem} "
                  f"plan={tuple(alt)} kernel_ms={alt_ms:.4f} "
                  f"bitwise={alt_equal}", flush=True)
        del want
        del bins, trees
    if args.sass:
        _sass(_build.LIBRARY)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)


if __name__ == "__main__":
    main()
