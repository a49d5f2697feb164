#!/usr/bin/env python3
"""Time K1 (``hist_matmul_kernel``) beside variants with one part removed.

Run from the root of a checkout on a machine with an H100:

    python3 dmlc_core_tpu_torch/tools/k1_variants.py [--sass DIR]

Each variant is ``csrc/hist.cu`` with one edit, built by its own ``nvcc``
(all started together) into ``build/k1_variants/``:

- ``kernel``: the source as it is;
- ``no_mma``: each ``mma`` replaced by one f32 add of its operands, so the
  one-hot build, ``ldmatrix`` and staging remain;
- ``no_refill``: only the first tile is staged; later tiles compute on it;
- ``no_compute``: the staging ring alone.

At 2,000,000 rows x 28 uint8 features x 256 bins and M = 16, 64 (the
weight rows of 1 and 32 nodes), it prints CUDA-event milliseconds per
launch beside the dense tensor-core time, the card's name and power
limit, and ``kernel`` once more with the row chunks rounded up rather
than down.  Only ``kernel`` computes the histogram; its result is held
against the plain version.  ``--sass DIR`` writes the SASS of ``kernel`` there.
The time a part takes is about ``kernel`` less the variant without it.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from dmlc_core_tpu_torch.ops import _build, hist_cuda  # noqa: E402
from dmlc_core_tpu_torch.utils.timer import cuda_event_ms  # noqa: E402

MMA = ("for (int mt = 0; mt < MT; ++mt) "
       "mma_bf16(acc[mt][j], a[mt], b0, b1);")
EDITS = {
    "kernel": [],
    "no_mma": [(MMA, "for (int mt = 0; mt < MT; ++mt) acc[mt][j][0] += "
                     "__uint_as_float((b0 ^ b1 ^ a[mt][0]) & 0x3fffffffu);")],
    "no_refill": [("stage_tile(k + 1);\n      cp_async_wait<1>();",
                   "cp_async_wait<0>();")],
    "no_compute": [("    if (active) {\n      const long long t0",
                    "    if (active && k < 0) {\n      const long long t0")],
}


def build_all(out_dir):
    with open(_build.SOURCE, encoding="utf-8") as fh:
        src = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w", encoding="utf-8") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out_dir, f"{name}.so"), cu]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = _build._bind(ctypes.CDLL(
            os.path.join(out_dir, f"{name}.so")))
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", help="directory for the kernel's SASS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out_dir = os.path.join(ROOT, "build", "k1_variants")
    libs = build_all(out_dir)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass",
                               os.path.join(out_dir, "kernel.so")],
                              capture_output=True, text=True).stdout
        with open(os.path.join(args.sass, "k1_sass.txt"), "w",
                  encoding="utf-8") as f:
            f.write(sass)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = 2_000_000, 28, 256
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    stream = torch.cuda.current_stream().cuda_stream
    print(card)
    for M in (16, 64):
        w = torch.randn(M, B, device=dev, generator=gen).to(torch.bfloat16)
        plan = hist_cuda.hist_matmul_plan(M, B, F, nb, 1)
        out = torch.empty(M, F * nb, device=dev)
        part = torch.empty(plan.n_chunks * M * F * nb, device=dev)
        dense = 1e3 * 2 * M * B * F * nb / 989e12
        for name, lib in libs.items():
            def launch():
                rc = lib.dmlc_hist_matmul(
                    w.data_ptr(), bins.data_ptr(), 1, B, F, F, 0, M, nb, B,
                    plan.rows_per_chunk, plan.n_chunks, part.data_ptr(),
                    out.data_ptr(), stream)
                if rc != 0:
                    raise SystemExit(f"{name}: launch failed ({rc})")
            ms = cuda_event_ms(launch, iters=10, warmup=2)
            line = f"M={M} {name:10s} ms={ms:.3f} dense_tc_ms={dense:.3f}"
            if name == "kernel":
                launch()
                want = hist_cuda.hist_matmul_ref(w, bins, nb)
                if not torch.allclose(out, want, rtol=1e-4, atol=1e-3):
                    raise SystemExit("kernel disagrees with the plain version")
                line += " (agrees with the plain version)"
            print(line, flush=True)
        # the kernel with the row chunks rounded up, as K3's plan does
        n_up, rpc_up = hist_cuda._chunks(B, plan.groups * plan.m_blocks)
        part_up = torch.empty(n_up * M * F * nb, device=dev)

        def launch_up():
            rc = libs["kernel"].dmlc_hist_matmul(
                w.data_ptr(), bins.data_ptr(), 1, B, F, F, 0, M, nb, B,
                rpc_up, n_up, part_up.data_ptr(), out.data_ptr(), stream)
            if rc != 0:
                raise SystemExit(f"chunks rounded up: launch failed ({rc})")
        print(f"M={M} kernel with {n_up} chunks (rounded up; the plan has "
              f"{plan.n_chunks}) ms={cuda_event_ms(launch_up, iters=10, warmup=2):.3f}",
              flush=True)
        del w, out, part, part_up


if __name__ == "__main__":
    main()
