#!/usr/bin/env python3
"""Time K3 (``grad_hist_fused_kernel``) beside variants with one part removed.

Run from the root of a checkout on a machine with an H100:

    python3 dmlc_core_tpu_torch/tools/k3_variants.py [--sass DIR]

Each variant is ``csrc/hist.cu`` with one edit to K3 (K1 is left as it
is), built by its own ``nvcc`` (all started together) into
``build/k3_variants/``:

- ``kernel``: the source as it is;
- ``no_mma``: each ``mma`` replaced by one XOR of its operands into the
  accumulator's bits, so the A and B builds and the staging remain;
- ``no_a_build``: A taken from the packed g and h words as they are, with
  no node compare and no mask, so every m-tile multiplies the same A;
- ``no_b_build``: B taken from the packed one-hot patterns as they are,
  with no ``set.eq.bf16x2``;
- ``no_compute``: the row loads and the packing alone;
- ``unroll_1``, ``unroll_2``, ``unroll_4``: the k-step loop unrolled
  once, twice or four times at every m-tile count (the kernel: four times
  at 1-2 m-tiles, once at 3-4);
- ``blocks_1``: launch bounds asking for one CTA an SM at every m-tile
  count (the kernel: 3 at 1 m-tile, 2 at 2), so more registers a thread
  and fewer warps to hide latency.

At 2,000,000 rows x 28 uint8 features x 256 bins and n = 1, 16 and 32
nodes (one m-tile, two and four), it prints CUDA-event milliseconds per launch beside
the dense tensor-core time, the registers a thread of each K3 instance
uses (``ptxas -v``), and the card's name and power limit.  Only
``kernel`` computes the histogram; it is held against the plain
version.  ``--sass DIR`` writes the SASS of
``kernel`` there.  The time a part takes is about ``kernel`` less the
variant without it.
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
K3_TILE = "// K3's k-steps of one packed tile"
K3_KERNEL = "grad_hist_fused_kernel(const BinT* __restrict__ bins,"
K3_DOC = "// K3.  Grid (unit group"
UNROLL = "#pragma unroll (MT >= 3 ? 1 : 4)"
BOUNDS = """__launch_bounds__(kWarps * 32,
                                  MT == 1 ? 3 : MT == 2 ? 2 : 1)"""
MMA = ("for (int mt = 0; mt < MT; ++mt) "
       "mma_bf16(acc[mt][j], a[mt], b0, b1);")
A_BUILD = """      const unsigned in_lo = f16x2_eq_mask(lo.x, node2[mt]);
      const unsigned in_hi = f16x2_eq_mask(hi.x, node2[mt]);
      a[mt][0] = in_lo & lo.y;   // G row of the lane's node
      a[mt][1] = in_lo & lo.z;   // its H row
      a[mt][2] = in_hi & hi.y;
      a[mt][3] = in_hi & hi.z;"""
B_SET = """      const unsigned b0 = bf16x2_eq_one(pat.x, bin2[j]);
      const unsigned b1 = bf16x2_eq_one(pat.y, bin2[j]);"""
EDITS = {
    "kernel": [],
    # one 3-input XOR into the accumulator's bits in place of each mma
    "no_mma": [(K3_TILE, MMA,
                "for (int mt = 0; mt < MT; ++mt) acc[mt][j][0] = "
                "__uint_as_float(__float_as_uint(acc[mt][j][0]) ^ b0 ^ b1 "
                "^ a[mt][j & 3]);")],
    "no_a_build": [(K3_TILE, A_BUILD,
                    "      a[mt][0] = lo.y;\n      a[mt][1] = lo.z;\n"
                    "      a[mt][2] = hi.y;\n      a[mt][3] = hi.z;")],
    "no_b_build": [(K3_TILE, B_SET,
                    "      const unsigned b0 = pat.x, b1 = pat.y;")],
    "no_compute": [(K3_KERNEL, "    if (active) {",
                    "    if (active && k < 0) {")],
    "unroll_1": [(K3_TILE, UNROLL, "#pragma unroll 1")],
    "unroll_2": [(K3_TILE, UNROLL, "#pragma unroll 2")],
    "unroll_4": [(K3_TILE, UNROLL, "#pragma unroll 4")],
    "blocks_1": [(K3_DOC, BOUNDS, "__launch_bounds__(kWarps * 32, 1)")],
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
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for anchor, old, new in edits:
            text = _edit(text, anchor, old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w", encoding="utf-8") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out_dir, f"{name}.so"), cu]
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


def k3_registers(log):
    """{(bins dtype, m-tiles): (registers, spill store bytes)} of K3's
    instances in a ptxas -v log."""
    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"grad_hist_fused_kernelI([hi])Li(\d)E", line)
        if "Compiling entry" in line:
            entry = (("uint8" if m.group(1) == "h" else "int32"),
                     int(m.group(2))) if m else None
            spill = 0
        elif entry and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores",
                                  line).group(1))
        elif entry and "Used" in line:
            out[entry] = (int(re.search(r"Used (\d+) registers",
                                        line).group(1)), spill)
            entry = None
    return out


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
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass",
                               os.path.join(out_dir, "kernel.so")],
                              capture_output=True, text=True).stdout
        with open(os.path.join(args.sass, "k3_sass.txt"), "w",
                  encoding="utf-8") as f:
            f.write(sass)
    print(card)
    for name in EDITS:
        regs = k3_registers(logs[name])
        print(f"{name:10s} registers a thread (spill stores): " + ", ".join(
            f"{dt} MT={mt}: {r} ({sp} B)"
            for (dt, mt), (r, sp) in sorted(regs.items())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = 2_000_000, 28, 256
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    grad = torch.randn(B, device=dev, generator=gen)
    hess = torch.rand(B, device=dev, generator=gen)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (1, 16, 32):
        node = torch.randint(-1, n, (B,), device=dev, generator=gen,
                             dtype=torch.int32)
        plan = hist_cuda.grad_hist_fused_plan(n, B, F, nb, 1)
        out = torch.empty(2, n, F, nb, device=dev)
        part = torch.empty(plan.n_chunks * out.numel(), device=dev)
        m_rows = 16 * plan.m_tiles * plan.m_blocks
        dense = 1e3 * 2 * m_rows * B * F * nb / 989e12
        want = hist_cuda.grad_hist_fused_ref(bins, node, grad, hess, n, nb)
        for name, lib in libs.items():
            def launch():
                rc = lib.dmlc_grad_hist_fused(
                    bins.data_ptr(), 1, node.data_ptr(), grad.data_ptr(),
                    hess.data_ptr(), B, F, F, 0, n, nb, plan.rows_per_chunk,
                    plan.n_chunks, part.data_ptr(), out.data_ptr(), stream)
                if rc != 0:
                    raise SystemExit(f"{name}: launch failed ({rc})")
            ms = cuda_event_ms(launch, iters=10, warmup=2)
            line = (f"n={n:2d} M={m_rows} {name:10s} ms={ms:.3f} "
                    f"dense_tc_ms={dense:.3f}")
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
