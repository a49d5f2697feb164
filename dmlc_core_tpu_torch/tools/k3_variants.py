#!/usr/bin/env python3
"""Time K3 (``grad_hist_fused_kernel``) beside variants with one part removed.

Run from the root of a checkout on a machine with an H100:

    python3 dmlc_core_tpu_torch/tools/k3_variants.py [--sass DIR]

Each variant is ``csrc/hist.cu`` with one edit to K3 (K1 is left as it
is), built by its own ``nvcc`` (all started together) into
``build/k3_variants/``:

- ``kernel``: the source as it is;
- ``no_wgmma``: each ``wgmma`` replaced by one XOR of its A registers into
  an accumulator's bits, so the A build, the B build and the copies remain;
- ``no_a_build``: A taken from the one-hot patterns as they are, with no
  ``set.eq.bf16x2``;
- ``no_b_build``: the producer writes no B rows (the copies and the
  patterns remain), so the wgmmas read whatever the stage holds;
- ``no_compute``: the consumers build no A and run no wgmma (they wait
  for each stage and release it), so the copies and the producer's builds
  alone.

At 2,000,000 rows x 28 uint8 features x 256 bins and n = 1, 8, 16, 32 and
256 nodes it prints CUDA-event milliseconds per launch beside the dense
tensor-core time (``2 * 64 * N * blocks * B * F * slices / 989e12``), the
registers and spill bytes of each K3 instance (``ptxas -v``), any
``ptxas`` warning about K3, and the card's name and power limit.  Only
``kernel`` computes the histogram; it is held against the plain
version.  ``--sass DIR`` writes the SASS of ``kernel`` there and prints
the count of ``HGMMA`` and ``HMMA`` instructions in each K3 instance.  The
time a part takes is about ``kernel`` less the variant without it.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from dmlc_core_tpu_torch.ops import _build, hist_cuda  # noqa: E402
from dmlc_core_tpu_torch.utils.timer import cuda_event_ms  # noqa: E402

# where each edit applies: the first match after its anchor
K3_STEP = "__device__ __forceinline__ void k3_step("
K3_KERNEL = "grad_hist_fused_kernel(const BinT* __restrict__ bins,"
MMA = "for (int k = 0; k < U; ++k) Wgmma<N>::mma(acc[k], a[k], desc);"
A_SET = """    a[k][0] = bf16x2_eq_one(lo[k], m0[k]);
    a[k][1] = bf16x2_eq_one(lo[k], m1[k]);
    a[k][2] = bf16x2_eq_one(hi[k], m0[k]);
    a[k][3] = bf16x2_eq_one(hi[k], m1[k]);"""
B_BUILD = """#pragma unroll
        for (int q = 0; q < N / 8; ++q)
          *reinterpret_cast<uint4*>(b_st + b_chunk<N>(r, q)) =
              make_uint4(0, 0, 0, 0);
        if (loc < n_count)"""
STEP_LO = "k3_step<N, U>(acc, lo, hi, m0, m1, b0 + 64 * N * j);"
STEP_HI = "k3_step<N, U>(acc, lo2, hi2, m0, m1, b0 + 64 * N * j + 32 * N);"
EDITS = {
    "kernel": [],
    # one 3-input XOR of the A registers into an accumulator's bits
    "no_wgmma": [(K3_STEP, MMA,
                  "for (int k = 0; k < U; ++k) acc[k][0] = __uint_as_float("
                  "__float_as_uint(acc[k][0]) ^ a[k][0] ^ a[k][1] ^ a[k][2] "
                  "^ a[k][3]);")],
    "no_a_build": [(K3_STEP, A_SET,
                    "    a[k][0] = lo[k];\n    a[k][1] = lo[k];\n"
                    "    a[k][2] = hi[k];\n    a[k][3] = hi[k];")],
    "no_b_build": [(K3_KERNEL, B_BUILD, "        if (false)")],
    "no_compute": [(K3_KERNEL, STEP_LO, ""), (K3_KERNEL, STEP_HI, "")],
}
EXACT = ("kernel",)


def _edit(text, anchor, old, new):
    at = text.find(anchor)
    hit = text.find(old, at)
    if at < 0 or hit < 0:
        raise SystemExit(f"the source no longer holds {old!r} after "
                         f"{anchor!r}")
    return text[:hit] + new + text[hit + len(old):]


def build_all(out_dir):
    with open(_build.SOURCE, encoding="utf-8") as fh:
        src = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    # the other kernels, unchanged, so that the variant binds like the library
    others = [f for f in _build.sources() if f != _build.SOURCE]
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for anchor, old, new in edits:
            text = _edit(text, anchor, old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w", encoding="utf-8") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out_dir, f"{name}.so"), cu, *others]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{logs[name][-3000:]}")
        libs[name] = _build._bind(ctypes.CDLL(
            os.path.join(out_dir, f"{name}.so")))
    return libs, logs


def _instance(line):
    """(bins dtype, N) of a K3 instance named in a ptxas or SASS line."""
    m = re.search(r"grad_hist_fused_kernelI([hi])Li(\d+)E", line)
    return (("uint8" if m.group(1) == "h" else "int32"),
            int(m.group(2))) if m else None


def k3_registers(log):
    """{(bins dtype, N): (registers, spill store bytes)} of K3's instances
    in a ptxas -v log, and the log's warnings that name K3 or wgmma."""
    out, entry, spill, warnings = {}, None, 0, []
    for line in log.splitlines():
        if "warning" in line and ("grad_hist_fused" in line
                                  or "wgmma" in line):
            warnings.append(line.strip())
        if "Compiling entry" in line:
            entry = _instance(line)
            spill = 0
        elif entry and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores",
                                  line).group(1))
        elif entry and "Used" in line:
            out[entry] = (int(re.search(r"Used (\d+) registers",
                                        line).group(1)), spill)
            entry = None
    return out, warnings


def sass_counts(sass):
    """{(bins dtype, N): (HGMMA count, HMMA count)} of K3's instances."""
    out, entry = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            entry = _instance(line)
            if entry:
                out[entry] = [0, 0]
        elif entry:
            if "HGMMA" in line:
                out[entry][0] += 1
            elif re.search(r"\bHMMA\b", line):
                out[entry][1] += 1
    return {k: tuple(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", help="directory for the kernel's SASS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out_dir = os.path.join(ROOT, "build", "k3_variants")
    libs, logs = build_all(out_dir)
    print(card)
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass",
                               os.path.join(out_dir, "kernel.so")],
                              capture_output=True, text=True).stdout
        with open(os.path.join(args.sass, "k3_sass.txt"), "w",
                  encoding="utf-8") as f:
            f.write(sass)
        for (dt, n), (hg, hm) in sorted(sass_counts(sass).items()):
            print(f"SASS {dt} N={n}: HGMMA {hg}, HMMA {hm}")
    for name in EDITS:
        regs, warnings = k3_registers(logs[name])
        print(f"{name:13s} registers a thread (spill stores): " + ", ".join(
            f"{dt} N={n}: {r} ({sp} B)"
            for (dt, n), (r, sp) in sorted(regs.items())))
        for w in warnings:
            print(f"{name:13s} {w}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = 2_000_000, 28, 256
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    grad = torch.randn(B, device=dev, generator=gen)
    hess = torch.rand(B, device=dev, generator=gen)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (1, 8, 16, 32, 256):
        node = torch.randint(-1, n, (B,), device=dev, generator=gen,
                             dtype=torch.int32)
        out = torch.empty(2, n, F, nb, device=dev)
        want = hist_cuda.grad_hist_fused_ref(bins, node, grad, hess, n, nb)
        plan = hist_cuda.grad_hist_fused_plan(n, B, F, nb, 1)
        part = torch.empty(plan.n_chunks * out.numel(), device=dev)
        dense = (1e3 * 2 * 64 * plan.cols * plan.m_blocks * B * F
                 * plan.slices / 989e12)
        for name, lib in libs.items():
            def launch():
                rc = lib.dmlc_grad_hist_fused(
                    bins.data_ptr(), 1, node.data_ptr(), grad.data_ptr(),
                    hess.data_ptr(), B, F, F, 0, n, nb, plan.rows_per_chunk,
                    plan.n_chunks, part.data_ptr(), out.data_ptr(), stream)
                if rc != 0:
                    raise SystemExit(f"{name}: launch failed ({rc})")
            ms = cuda_event_ms(launch, iters=10, warmup=2)
            line = (f"n={n:3d} N={plan.cols}x{plan.m_blocks} {name:13s} "
                    f"ms={ms:.3f} dense_tc_ms={dense:.3f}")
            if name in EXACT:
                launch()
                if not all(torch.allclose(a, b, rtol=1e-4, atol=1e-3)
                           for a, b in zip(out, want)):
                    raise SystemExit(f"{name} disagrees with the plain "
                                     f"version at n={n}")
                line += " (agrees with the plain version)"
            print(line, flush=True)
        del node, out, part, want


if __name__ == "__main__":
    main()
