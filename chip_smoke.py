#!/usr/bin/env python3
"""Drive the PyTorch port's hist-GBDT path on one CUDA card and check it.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles ``dmlc_core_tpu_torch/csrc/hist.cu`` with nvcc and
   prints the build seconds and the ptxas report; the probe
   (``kernels_available``) checks K1, K2 and K3 on a small case;
3. kernels: at 2,000,000 rows x 28 features x 256 bins and 1, 32 and 256
   nodes, K2 (``grad_hist_cuda``, which launches K3's kernel: one K3
   launch and no K1 launch a call) and K3 (``grad_hist_fused_cuda``)
   against their plain PyTorch version on the card (rtol 1e-4, atol 1e-3:
   f32 sums in another order), bitwise repeatability of two launches (and
   of the plain version, whose segment sums are atomics-free), and
   CUDA-event times beside the bound and one ``index_add_`` over
   precomputed flat ids (the scatter formulation); at 32 nodes also both
   on the column window 14..27 read in place (row stride 28, offset 14)
   against the plain version on a copy, bitwise over two launches; K1
   (``hist_matmul_cuda``) at 1 and 32 nodes on the W the reference's K2
   would build, and alone on ragged shapes
   (1,000,003 rows, 48 weight rows, 255 bins with bins out of range, uint8
   on all columns and int32 on the window 14..27), and K3
   (``grad_hist_fused_cuda``) alone on ragged shapes (1,000,003 rows; 1, 5,
   13, 37 and 256 nodes with node ids in [-2, n + 3); 255 bins with bins
   out of range in int32; windows 14..27 and 2..4; tensors at an offset in
   their allocations), each against its plain version, bitwise over two
   launches and with its launches counted; the K1, K2 and K3 lines also
   give the dense tensor-core time 2*M*B*F*nbins at 989 TFLOP/s beside
   the bound (for K2 and K3, M = 16 A rows per 8-node m-tile computed);
4. GBDT: ``fit_binned`` (10 rounds, depth 6, 256 bins, learning rate 0.3)
   on 2,000,000 HIGGS-shaped rows binned to the uint8 wire, twice through
   ``hist_method="auto"`` (K2) and once through ``"pallas_fused"`` (K3),
   with launch counts read around that run: K3's kernel on every level of
   the three fits, K1 never, and the ``"auto"`` fit's ensemble and margin
   bitwise equal to the ``"pallas_fused"`` fit's; ``predict`` on 200,000
   held-out rows; two ``"scatter"`` fits of the same rows (segment sums,
   no kernel), bitwise equal; then a 200,000-row fit on the card against
   the same fit on the CPU with the plain versions;
5. distributed GBDT: four worker processes of this script share the card
   as a 2 x 2 data x model mesh over gloo (NCCL refuses two ranks on one
   card).  Each takes the 1,000,000 rows of its data coordinate of the
   phase-4 shape, makes the bin edges with the distributed quantile sketch,
   bins them to uint8 and fits ``GBDT(model_axis="model")`` with
   ``"pallas"`` and ``"pallas_fused"``, so every level runs K4 (K3's
   windowed kernel on the rank's 14 columns, the data all-reduce, the model
   all-gather).  All ranks must hold the same edges and ensembles, the two
   methods' ensembles must be bitwise equal on every rank, K4 must
   launch on every level, the global accuracy must reach 0.8, and a
   single-process card fit with the same edges must grow the same first
   tree.  Inside the workers K4 at 32 nodes is held against the plain
   histogram of the whole global array and timed beside its bound and the
   collectives.  Then one worker with world size 1 over NCCL fits 200,000
   rows with ``model_axis`` and must match the plain card fit bitwise;
6. ingest: the first 500,000 of phase 4's training rows are written as
   libsvm text (``%.9g``, so every float32 survives) and the first
   200,000 as CSV with the label column, then parsed with the port's
   threaded ``create_parser`` (default thread count) and
   ``dense_batches(8192)``: the parsed features and labels must be
   bitwise the written arrays.  Edges on the first 50,000 parsed rows,
   ``binned_batches`` (the wire must be bitwise phase 4's
   ``binner.transform`` of the same rows), ``DeviceFeedLoader`` through
   its pinned ring into one preallocated tensor on the card (bitwise
   ``torch.from_numpy(wire).to(card)``), timed beside a synchronous
   pageable ``.to(card)``, then ``fit_binned`` with labels only, as
   phase 4 fits: its ensemble and margin must be bitwise the phase-4
   model's fit of the same rows from memory, with K3's kernel on every
   level and K1 never (counts set to 0 before the parse, read after the
   fit, printed on a line of their own).  Last, ``python -m
   dmlc_core_tpu_torch.examples.train_gbdt`` on the libsvm file must exit
   0 with train accuracy >= 0.8.  Writing and parsing all 2,000,000 rows,
   twice with the CLI, would not fit phase 6's ~120 s.

The line before the last is a JSON object with one entry per kernel (K1,
K3, K4; K2 has no kernel of its own).  Each ``launches`` is the count of
the main path's run (phase 4 for K1 and K3, phase 5 for K4), with the
counts set to 0 just before it: K1 is on no main path, so its count is 0
(phase 3 prints its launches there on a line of their own, and phase 6
those of the ingest path).  The last line is ``{"ok": true, "device":
{...}}``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 2_000_000
N_HELDOUT = 200_000
N_AGREE = 200_000
N_FEATURES = 28
NUM_BINS = 256
MAX_DEPTH = 6
ROUNDS = 10
RTOL, ATOL = 1e-4, 1e-3
MESH = {"data": 2, "model": 2}
QUANTILE_SAMPLE = 50_000      # rows per shard the bin edges are fit on
WORKER_TIMEOUT_S = 420       # wall clock of each phase-5 launch
COLLECTIVE_TIMEOUT_S = 300   # a dead peer fails the run after this
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores
BF16_TC_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
RAGGED_ROWS = 1_000_003       # K1's and K3's ragged-shape checks
N_INGEST = 500_000            # phase 6's libsvm rows (writing and parsing
N_CSV = 200_000               # 2M rows twice would not fit its ~120 s)
INGEST_BATCH = 8192
CLI_TIMEOUT_S = 300
K3_RAGGED = [
    # num_nodes, num_bins, bins dtype, (lo, hi) of the bins, f_offset,
    # f_count, offset of the tensors in their allocations (elements); node
    # ids are drawn from [-2, num_nodes + 3)
    (1, 256, torch.uint8, (0, 256), 0, None, 0),
    (5, 255, torch.int32, (-3, 260), 14, 14, 3),
    (13, 255, torch.uint8, (0, 256), 2, 3, 1),
    (37, 255, torch.int32, (-3, 260), 14, 14, 0),
    (256, 255, torch.uint8, (0, 256), 0, None, 5),
]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_higgs_like(n, f, seed=0):
    """HIGGS-shaped synthetic data: a noisy linear decision surface."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f).astype(np.float32)
    y = ((x @ w + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return x, y


def phase_device():
    print("== phase 1: device", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build():
    from dmlc_core_tpu_torch.ops import _build, hist_cuda

    print("== phase 2: build", flush=True)
    start = time.perf_counter()
    _build.load_library()
    info = _build.BUILD_INFO
    print(f"built {_build.LIBRARY} in {time.perf_counter() - start:.2f} s "
          f"(nvcc {info.get('seconds', 0.0):.2f} s, cached="
          f"{info.get('cached')})")
    for line in str(info.get("ptxas", "")).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    if not hist_cuda.kernels_available():
        fail("kernels_available() is False on a card")
    print("probe: K1, K2 and K3 agree with their plain versions",
          flush=True)


def _bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _max_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def _check_close(name, got, want):
    for a, b in zip(got, want):
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"{name} disagrees with its plain version: max abs err "
                 f"{_max_err(got, want):.3g}")


def _bitwise(fn):
    first, again = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    return all(torch.equal(a, b) for a, b in zip(first, again))


def phase_kernels():
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    print("== phase 3: kernels at 2,000,000 x 28 x 256", flush=True)
    hist_cuda.reset_launches()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = N_ROWS, N_FEATURES, NUM_BINS
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    grad = torch.randn(B, device=dev, generator=gen)
    hess = torch.rand(B, device=dev, generator=gen)
    entries = {}
    for n in (1, 32, 256):
        node = torch.randint(-1, n, (B,), device=dev, generator=gen,
                             dtype=torch.int32)
        live = int(((node >= 0) & (node < n)).sum().item())
        # the scatter formulation as one library call: flat ids for G and H
        ids = (node.long()[:, None] * (F * nb)
               + torch.arange(F, device=dev)[None, :] * nb + bins.long())
        nseg = n * F * nb
        ok = (node >= 0)[:, None].expand(B, F)
        flat = torch.cat([torch.where(ok, ids, 2 * nseg),
                          torch.where(ok, ids + nseg, 2 * nseg)]).reshape(-1)
        src = torch.cat([grad[:, None].expand(B, F),
                         hess[:, None].expand(B, F)]).reshape(-1)
        lib_out = torch.zeros(2 * nseg + 1, device=dev)
        library_ms = cuda_event_ms(lambda: lib_out.index_add_(0, flat, src),
                                   iters=5, warmup=1)
        del ids, ok, flat, src, lib_out

        want = hist_cuda.grad_hist_ref(bins, node, grad, hess, n, nb)
        args = (bins, node, grad, hess, n, nb)
        if not _bitwise(lambda: hist_cuda.grad_hist_ref(*args)):
            fail(f"the plain version (segment sums) is not bitwise "
                 f"repeatable at n={n}")
        # K2 and K3 compute one function: bins, node/g/h in, (G, H) out;
        # both run K3's kernel with one plan
        nbytes = B * F + 12 * B + 2 * n * F * nb * 4
        bound, by = _bound_ms(nbytes, 2 * live * F)
        plan = hist_cuda.grad_hist_fused_plan(n, B, F, nb, 1)
        m_rows = 16 * plan.m_tiles * plan.m_blocks
        cases = [("grad_hist_cuda", lambda: hist_cuda.grad_hist_cuda(*args),
                  lambda: hist_cuda.grad_hist_ref(*args)),
                 ("grad_hist_fused_cuda",
                  lambda: hist_cuda.grad_hist_fused_cuda(*args),
                  lambda: hist_cuda.grad_hist_fused_ref(*args))]
        for name, fn, ref in cases:
            before = dict(hist_cuda.LAUNCHES)
            got = fn()
            if (hist_cuda.LAUNCHES["grad_hist_fused_cuda"]
                    != before["grad_hist_fused_cuda"] + 1
                    or hist_cuda.LAUNCHES["hist_matmul_cuda"]
                    != before["hist_matmul_cuda"]):
                fail(f"{name} at n={n}: launches went from {before} to "
                     f"{hist_cuda.LAUNCHES}, expected one K3 launch")
            _check_close(name, got, want)
            err = _max_err(got, want)
            same = _bitwise(fn)
            if not same:
                fail(f"{name} is not bitwise repeatable at n={n}")
            ms = cuda_event_ms(fn, iters=5, warmup=1)
            plain_ms = cuda_event_ms(ref, iters=3, warmup=1)
            print(f"{name:22s} n={n:3d} max_abs_err={err:.3g} (rtol {RTOL}, "
                  f"atol {ATOL}) bitwise={same} ms={ms:.3f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by}) "
                  f"dense_tc_ms={_dense_tc_ms(m_rows, B, F, nb):.4f} "
                  f"(M={m_rows}) library_ms={library_ms:.3f}", flush=True)
            if name == "grad_hist_fused_cuda":
                entries[("K3", n)] = dict(
                    name="grad_hist_fused_cuda", route="cuda",
                    source="dmlc_core_tpu_torch/csrc/hist.cu",
                    replaces="dmlc_core_tpu/ops/hist_pallas.py:250",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=library_ms)
        if n == 32:
            # the column window K4 hands the kernels: columns 14..27 of the
            # 28-column rows, read in place (row stride 28, offset 14)
            f0 = F // 2
            want_w = hist_cuda.grad_hist_ref(bins[:, f0:].contiguous(), node,
                                             grad, hess, n, nb)
            for name, fn in (("grad_hist_cuda", hist_cuda.grad_hist_cuda),
                             ("grad_hist_fused_cuda",
                              hist_cuda.grad_hist_fused_cuda)):
                def window(fn=fn):
                    return fn(bins, node, grad, hess, n, nb, f0, F - f0)
                got = window()
                _check_close(f"{name} at f_offset={f0}", got, want_w)
                if not _bitwise(window):
                    fail(f"{name} is not bitwise repeatable on columns "
                         f"{f0}..{F - 1}")
                print(f"{name:22s} n={n:3d} columns {f0}..{F - 1} in place: "
                      f"max_abs_err={_max_err(got, want_w):.3g} bitwise=True",
                      flush=True)
            del want_w, got
        # K1 alone on the W the reference's K2 builds (in one sweep)
        if hist_cuda.hist_node_block(n, F, nb) == n:
            w = hist_cuda.node_weights(node, grad, hess, n)
            M = w.shape[0]
            got = hist_cuda.hist_matmul_cuda(w, bins, nb)
            ref_out = hist_cuda.hist_matmul_ref(w, bins, nb)
            _check_close("hist_matmul_cuda", (got,), (ref_out,))
            err = _max_err((got,), (ref_out,))
            if not _bitwise(lambda: hist_cuda.hist_matmul_cuda(w, bins, nb)):
                fail(f"hist_matmul_cuda is not bitwise repeatable at n={n}")
            ms = cuda_event_ms(lambda: hist_cuda.hist_matmul_cuda(w, bins,
                                                                  nb),
                               iters=5, warmup=1)
            plain_ms = cuda_event_ms(
                lambda: hist_cuda.hist_matmul_ref(w, bins, nb), iters=3,
                warmup=1)
            nbytes = 2 * M * B + B * F + M * F * nb * 4
            bound, by = _bound_ms(nbytes, M * B * F)
            print(f"{'hist_matmul_cuda':22s} n={n:3d} M={M} max_abs_err="
                  f"{err:.3g} bitwise=True ms={ms:.3f} plain_ms="
                  f"{plain_ms:.3f} bound_ms={bound:.4f} ({by}) "
                  f"dense_tc_ms={_dense_tc_ms(M, B, F, nb):.4f} "
                  f"library_ms={library_ms:.3f}", flush=True)
            entries[("K1", n)] = dict(
                name="hist_matmul_cuda", route="cuda",
                source="dmlc_core_tpu_torch/csrc/hist.cu",
                replaces="dmlc_core_tpu/ops/hist_pallas.py:148",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)
            del w, got, ref_out
        del node, want
        torch.cuda.empty_cache()
    _k1_ragged(bins.shape[1], gen)
    _k3_ragged(bins.shape[1], gen)
    print(f"hist_matmul_cuda launches in this phase's checks: "
          f"{hist_cuda.LAUNCHES['hist_matmul_cuda']}", flush=True)
    # the line reports the depth-6 main path's deepest level (32 nodes)
    return entries[("K1", 32)], entries[("K3", 32)]


def _dense_tc_ms(m, rows, features, num_bins):
    """K1's product W[M, B] @ onehot[B, F*nbins] done densely on the tensor
    cores at their peak: the time the tensor-core formulation needs."""
    return 1e3 * 2 * m * rows * features * num_bins / BF16_TC_OPS_PER_S


def _k1_ragged(F, gen):
    """K1 on shapes no tile divides: rows, weight rows and bins ragged,
    bins out of range, uint8 on all columns and int32 on a window."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    dev = torch.device("cuda")
    B, M, nb, f0 = RAGGED_ROWS, 48, 255, F // 2
    w = torch.randn(M, B, device=dev, generator=gen).to(torch.bfloat16)
    for dtype, lo, hi, off in ((torch.uint8, 0, 256, 0),
                               (torch.int32, -3, 260, f0)):
        rb = torch.randint(lo, hi, (B, F), device=dev, generator=gen,
                           dtype=torch.int32).to(dtype)
        count = F - off

        def k1():
            return hist_cuda.hist_matmul_cuda(w, rb, nb, off, count)
        got = k1()
        want = hist_cuda.hist_matmul_ref(w, rb[:, off:].contiguous(), nb)
        _check_close(f"hist_matmul_cuda on {B} x {F} {dtype}", (got,),
                     (want,))
        if not _bitwise(k1):
            fail(f"hist_matmul_cuda is not bitwise repeatable on {B} rows, "
                 f"{dtype}, columns {off}..{F - 1}")
        print(f"{'hist_matmul_cuda':22s} ragged B={B} M={M} nbins={nb} "
              f"{str(dtype).split('.')[-1]} columns {off}..{F - 1} (bins in "
              f"[{lo}, {hi})): max_abs_err={_max_err((got,), (want,)):.3g} "
              f"bitwise=True", flush=True)
        del rb, got, want
    del w
    torch.cuda.empty_cache()


def _k3_ragged(F, gen):
    """K3 on shapes no tile divides (``K3_RAGGED``: node counts that fill
    no m-tile or m-block, node ids and bins out of range, column windows,
    tensors at an offset in their allocations), each against its plain
    version on a copy of the window, bitwise over two launches, and every
    launch counted."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    dev = torch.device("cuda")
    B = RAGGED_ROWS
    for n, nb, dtype, (lo, hi), off, count, shift in K3_RAGGED:
        count = F - off if count is None else count
        rb = torch.randint(lo, hi, (B * F + shift,), device=dev,
                           generator=gen, dtype=torch.int32).to(dtype)
        rb = rb[shift:].view(B, F)
        node = torch.randint(-2, n + 3, (B + shift,), device=dev,
                             generator=gen, dtype=torch.int32)[shift:]
        g = torch.randn(B + shift, device=dev, generator=gen)[shift:]
        h = torch.rand(B + shift, device=dev, generator=gen)[shift:]

        def k3():
            return hist_cuda.grad_hist_fused_cuda(rb, node, g, h, n, nb, off,
                                                  count)
        before = hist_cuda.LAUNCHES["grad_hist_fused_cuda"]
        got = k3()
        want = hist_cuda.grad_hist_fused_ref(
            rb[:, off:off + count].contiguous(), node, g, h, n, nb)
        what = (f"grad_hist_fused_cuda on {B} x {F} {dtype}, n={n}, "
                f"columns {off}..{off + count - 1}, offset {shift}")
        _check_close(what, got, want)
        if not _bitwise(k3):
            fail(f"{what} is not bitwise repeatable")
        launched = hist_cuda.LAUNCHES["grad_hist_fused_cuda"] - before
        if launched != 3:
            fail(f"{what}: {launched} launches counted for 3 calls")
        print(f"{'grad_hist_fused_cuda':22s} ragged B={B} n={n} nbins={nb} "
              f"{str(dtype).split('.')[-1]} columns {off}..{off + count - 1} "
              f"offset {shift} (bins in [{lo}, {hi}), nodes in [-2, {n + 3})"
              f"): max_abs_err={_max_err(got, want):.3g} bitwise=True",
              flush=True)
        del rb, node, g, h, got, want
    torch.cuda.empty_cache()


def _split_agreement(a, b):
    split = a.split_feat >= 0
    same = (a.split_feat == b.split_feat) & (
        (a.split_bin == b.split_bin) | ~split)
    return same.float().mean().item()


def _same_tree(a, b, t):
    split = a.split_feat[t] >= 0
    return (torch.equal(a.split_feat[t], b.split_feat[t])
            and torch.equal(a.split_bin[t][split], b.split_bin[t][split])
            and torch.equal(a.default_left[t], b.default_left[t]))


def phase_gbdt(card):
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.ops.histogram import resolve_hist_method
    from dmlc_core_tpu_torch.utils.timer import device_time

    print("== phase 4: GBDT fit_binned + predict", flush=True)
    x, y = make_higgs_like(N_ROWS + N_HELDOUT, N_FEATURES)
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    model = GBDT(GBDTParam(**param), num_feature=N_FEATURES)
    model.make_bins(x[:50_000])
    binner = HostBinner(model.boundaries, NUM_BINS)
    wire = binner.transform(x)
    if wire.dtype != np.uint8:
        fail(f"wire dtype {wire.dtype}, expected uint8")
    dev = torch.device("cuda")
    bins = torch.from_numpy(wire[:N_ROWS]).to(dev)
    held = torch.from_numpy(wire[N_ROWS:]).to(dev)
    y_tr = torch.from_numpy(y[:N_ROWS]).to(dev)
    y_te = torch.from_numpy(y[N_ROWS:]).to(dev)
    method = resolve_hist_method(model.param.hist_method, bins)
    fused = GBDT(GBDTParam(hist_method="pallas_fused", **param),
                 num_feature=N_FEATURES)
    fused.set_boundaries(model.boundaries)
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    fits = []
    for m in (model, model, fused):
        (ens, margin), sec = device_time(m.fit_binned, bins, y_tr)
        fits.append((ens, margin, sec))
    prob = model.predict(fits[1][0], held)
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)

    need = ROUNDS * MAX_DEPTH
    print(f"hist method {method!r}; launches on the main path {launches} "
          f"(each fit needs >= {need} of K3's kernel, K1 none)")
    if launches["grad_hist_fused_cuda"] < 3 * need:
        fail(f"K3 launched {launches['grad_hist_fused_cuda']} times, "
             f"expected >= {3 * need}")
    if launches["hist_matmul_cuda"] != 0:
        fail(f"K1 launched {launches['hist_matmul_cuda']} times on the main "
             f"path, expected 0")
    for (ens, margin, sec), label in zip(
            fits, ("auto/K2 cold", "auto/K2 warm", "pallas_fused/K3")):
        if margin.shape != (N_ROWS,) or not torch.isfinite(margin).all():
            fail(f"{label}: bad training margin")
        acc = ((margin > 0).float() == y_tr).float().mean().item()
        print(f"fit {label}: {sec:.3f} s, {N_ROWS / sec:,.0f} rows/s, "
              f"train acc {acc:.4f} [{card}]", flush=True)
        if acc < 0.8:
            fail(f"{label}: train accuracy {acc:.4f} < 0.8")
    repeat = all(torch.equal(a, b)
                 for a, b in zip(fits[0][0], fits[1][0]))
    same = (all(torch.equal(a, b) for a, b in zip(fits[1][0], fits[2][0]))
            and torch.equal(fits[1][1], fits[2][1]))
    print(f"two auto fits bitwise identical: {repeat}; auto (K2) fit's "
          f"ensemble and margin bitwise equal to the pallas_fused (K3) "
          f"fit's: {same}")
    if not same:
        fail("the auto fit differs from the pallas_fused fit")
    if prob.shape != (N_HELDOUT,) or not torch.isfinite(prob).all():
        fail("bad held-out predictions")
    held_acc = ((prob > 0.5).float() == y_te).float().mean().item()
    print(f"held-out accuracy {held_acc:.4f} on {N_HELDOUT} rows")
    if held_acc < 0.8:
        fail(f"held-out accuracy {held_acc:.4f} < 0.8")
    _scatter_fits(card, param, model.boundaries, bins, y_tr)

    print(f"== card vs CPU plain versions on {N_AGREE} rows", flush=True)
    accs = {}
    ens = {}
    for where in ("cuda", "cpu"):
        m = GBDT(GBDTParam(hist_method="pallas", **param),
                 num_feature=N_FEATURES, device=where)
        m.set_boundaries(model.boundaries)
        (e, margin), sec = device_time(m.fit_binned, wire[:N_AGREE],
                                       y[:N_AGREE])
        margin = margin.cpu()
        ens[where] = type(e)(*(None if a is None else a.cpu() for a in e))
        accs[where] = ((margin > 0).float().numpy() == y[:N_AGREE]).mean()
        print(f"{where}: fit {sec:.3f} s, train acc "
              f"{accs[where]:.4f}")
    agree = _split_agreement(ens["cuda"], ens["cpu"])
    first = _same_tree(ens["cuda"], ens["cpu"], 0)
    print(f"split agreement {agree:.4f}; first tree identical {first}; "
          f"accuracy gap {abs(accs['cuda'] - accs['cpu']):.5f}")
    if not first:
        fail("the first tree differs between the card and the CPU")
    if abs(accs["cuda"] - accs["cpu"]) > 0.005:
        fail("card and CPU accuracies differ by more than 0.005")
    ref = dict(x=x, y=y, wire=wire, model=model, bins=bins, y_tr=y_tr)
    return launches, ref


def _scatter_fits(card, param, boundaries, bins, y):
    """Two ``"scatter"`` fits of the phase-4 rows: no kernel launched, the
    same bits twice (segment sums without float atomics)."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    model = GBDT(GBDTParam(hist_method="scatter", **param),
                 num_feature=N_FEATURES)
    model.set_boundaries(boundaries)
    torch.cuda.synchronize()
    # the scatter path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    fits = [device_time(model.fit_binned, bins, y) for _ in range(2)]
    launches = dict(hist_cuda.LAUNCHES)
    if set(launches.values()) != {0}:
        fail(f"the scatter fits launched kernels: {launches}")
    (ens, margin), _ = fits[0]
    same = (all(torch.equal(a, b) for a, b in zip(ens, fits[1][0][0]))
            and torch.equal(margin, fits[1][0][1]))
    acc = ((margin > 0).float() == y).float().mean().item()
    print(f"scatter fits: {fits[0][1]:.3f} s and {fits[1][1]:.3f} s, train "
          f"acc {acc:.4f}, no kernel launched; ensembles and margins "
          f"bitwise equal: {same} [{card}]", flush=True)
    if not same:
        fail("two scatter fits differ on the card")
    if acc < 0.8:
        fail(f"scatter: train accuracy {acc:.4f} < 0.8")


# -- phase 5: distributed GBDT ---------------------------------------------
def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_workers(mode, world, outdir, timeout_s):
    """Run ``world`` worker processes of this script with the DMLC_* env
    contract and a fresh coordinator port; fail on any failure or
    timeout, with each failed worker's stderr tail."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(outdir, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, DMLC_NUM_WORKER=str(world),
                   DMLC_TASK_ID=str(rank),
                   DMLC_COORDINATOR_URI="127.0.0.1",
                   DMLC_COORDINATOR_PORT=str(port), OMP_NUM_THREADS="2")
        out = open(os.path.join(outdir, f"{mode}{rank}.out"), "w")
        err = open(os.path.join(outdir, f"{mode}{rank}.err"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", mode,
             outdir], env=env, cwd=here, stdout=out, stderr=err), out, err))
    deadline = time.monotonic() + timeout_s
    failed = []
    try:
        for rank, (proc, _, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for proc, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    for rank, rc in failed:
        with open(os.path.join(outdir, f"{mode}{rank}.err")) as f:
            tail = f.read()[-3000:]
        print(f"--- {mode} worker {rank} ({rc}) stderr tail:\n{tail}",
              file=sys.stderr, flush=True)
    if failed:
        fail(f"{mode} workers failed: {failed}")
    with open(os.path.join(outdir, f"{mode}0.out")) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()


def _ensemble_arrays(ens):
    return {k: (None if a is None else a.cpu())
            for k, a in ens._asdict().items()}


def phase_distributed(card):
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 5: distributed GBDT, {MESH} mesh of 4 ranks on one "
          f"card (gloo)", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(here, "build", "chip_smoke_workers")
    shutil.rmtree(outdir, ignore_errors=True)     # no earlier run's results
    torch.cuda.empty_cache()
    start = time.perf_counter()
    _launch_workers("gloo", 4, outdir, WORKER_TIMEOUT_S)
    print(f"4 workers done in {time.perf_counter() - start:.1f} s")
    # written by the workers just above
    ranks = [torch.load(os.path.join(outdir, f"gloo{r}.pt"),
                        weights_only=False) for r in range(4)]
    need = ROUNDS * MAX_DEPTH
    x, y = make_higgs_like(N_ROWS, N_FEATURES)
    bounds = ranks[0]["boundaries"]
    for r in ranks:
        if not np.array_equal(r["boundaries"], bounds):
            fail(f"rank {r['rank']} has other bin edges than rank 0")
    wire = HostBinner(bounds, NUM_BINS).transform(x)
    dev = torch.device("cuda")
    bins = torch.from_numpy(wire).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    for method in ("pallas", "pallas_fused"):
        fits = [r["fits"][method] for r in ranks]
        for r, f in zip(ranks, fits):
            for k, a in f["ensemble"].items():
                if not torch.equal(a, fits[0]["ensemble"][k]):
                    fail(f"{method}: rank {r['rank']}'s {k} differs from "
                         f"rank 0's")
            k4 = f["launches"]["grad_hist_sharded_cuda"]
            if k4 < need:
                fail(f"{method}: rank {r['rank']} launched K4 {k4} times, "
                     f"expected >= {need}")
        correct = sum(f["correct"] for r, f in zip(ranks, fits)
                      if r["coord"]["model"] == 0)
        acc = correct / N_ROWS
        stages = {k: round(v, 4) for k, v in fits[0]["stages"].items()}
        print(f"{method}: 4 ranks bitwise identical; rank 0 fit "
              f"{fits[0]['seconds']:.3f} s (stages timed: {stages} s), "
              f"launches {fits[0]['launches']}, global train acc "
              f"{acc:.4f} [{card}]", flush=True)
        if acc < 0.8:
            fail(f"{method}: global train accuracy {acc:.4f} < 0.8")
        single = GBDT(GBDTParam(hist_method=method, **param),
                      num_feature=N_FEATURES)
        single.set_boundaries(bounds)
        (ens, margin), sec = device_time(single.fit_binned, bins, y_t)
        single_acc = ((margin > 0).float() == y_t).float().mean().item()
        dist_ens = TreeEnsemble(**fits[0]["ensemble"])
        one = TreeEnsemble(**_ensemble_arrays(ens))
        agree = _split_agreement(dist_ens, one)
        first = _same_tree(dist_ens, one, 0)
        print(f"{method}: single-card fit {sec:.3f} s, acc "
              f"{single_acc:.4f}; split agreement {agree:.4f}; first tree "
              f"identical {first}; accuracy gap {abs(acc - single_acc):.5f}",
              flush=True)
        if not first:
            fail(f"{method}: the distributed first tree differs from the "
                 f"single-card fit's")
        if abs(acc - single_acc) > 0.005:
            fail(f"{method}: distributed and single-card accuracies differ "
                 f"by more than 0.005")
    # K2 and K3 run one kernel: the two methods grow the same bits
    for r in ranks:
        k2, k3 = (r["fits"][m]["ensemble"] for m in ("pallas", "pallas_fused"))
        for k, a in k2.items():
            if (a is None) != (k3[k] is None) or (
                    a is not None and not torch.equal(a, k3[k])):
                fail(f"rank {r['rank']}: the pallas and pallas_fused "
                     f"ensembles differ in {k}")
    print("pallas and pallas_fused ensembles bitwise equal on every rank",
          flush=True)
    del bins, y_t, wire, x, y
    torch.cuda.empty_cache()
    k4 = ranks[0]["k4"]
    k4["launches"] = sum(ranks[0]["fits"][m]["launches"]
                         ["grad_hist_sharded_cuda"]
                         for m in ("pallas", "pallas_fused"))

    print("== phase 5b: world size 1 over NCCL, model_axis fit vs the "
          "plain card fit", flush=True)
    _launch_workers("nccl", 1, outdir, WORKER_TIMEOUT_S)
    return k4


def _time_serially(rank, fn):
    """``fn()`` on one rank at a time, the others waiting at a barrier, so
    kernel times are not shared with the other ranks on the card."""
    from dmlc_core_tpu_torch import collective

    out = None
    for r in range(collective.get_world_size()):
        if r == rank:
            out = fn()
        collective.allreduce(np.zeros(1, np.float32))    # barrier
    return out


def _k4_check(mesh, rank, lo, hi):
    """K4 at 32 nodes on the phase-3 shape, every rank taking part: the
    result after the collectives against the plain histogram of the whole
    global array, two calls bitwise, and times."""
    from dmlc_core_tpu_torch.collective.mesh_collectives import (
        MeshCollective)
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    B, F, nb, n = N_ROWS, N_FEATURES, NUM_BINS, 32
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    gbins = torch.from_numpy(rng.randint(0, nb, (B, F)).astype(np.uint8))
    gnode = torch.from_numpy(rng.randint(-1, n, B).astype(np.int32))
    gg = torch.from_numpy(rng.randn(B).astype(np.float32))
    gh = torch.from_numpy(rng.rand(B).astype(np.float32))
    local = [t[lo:hi].contiguous().to(dev) for t in (gbins, gnode, gg, gh)]
    want = hist_cuda.grad_hist_ref(*(t.to(dev) for t in
                                     (gbins, gnode, gg, gh)), n, nb)
    del gbins, gnode, gg, gh
    def k4():
        return hist_cuda.grad_hist_sharded_cuda(*local, n, nb, mesh, "model")
    got = k4()
    for a, b in zip(got, want):
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"K4 disagrees with the plain global histogram: max abs "
                 f"err {_max_err(got, want):.3g}")
    again = k4()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K4 is not bitwise repeatable")
    out = {"max_abs_err": _max_err(got, want),
           "k4_ms": cuda_event_ms(k4, iters=5, warmup=1)}
    del want, got, again
    f_count = F // mesh.shape["model"]
    f0 = mesh.coord("model") * f_count
    lb, ln, lg, lh = local
    piece = torch.stack(hist_cuda.grad_hist_fused_cuda(lb, ln, lg, lh, n, nb,
                                                       f0, f_count))
    data_c = MeshCollective(mesh, "data")
    model_c = MeshCollective(mesh, "model")
    out["all_reduce_ms"] = cuda_event_ms(lambda: data_c.psum(piece),
                                         iters=10, warmup=2)
    out["all_gather_ms"] = cuda_event_ms(
        lambda: model_c.allgather(piece, dim=2), iters=10, warmup=2)
    out["all_reduce_bytes"] = piece.numel() * 4
    out["all_gather_bytes"] = piece.numel() * 4 * mesh.shape["model"]

    def alone():
        res = {}
        # the rank's kernel alone: K3's kernel on its window
        res["ms"] = cuda_event_ms(lambda: hist_cuda.grad_hist_fused_cuda(
            lb, ln, lg, lh, n, nb, f0, f_count), iters=5, warmup=1)
        res["plain_ms"] = cuda_event_ms(lambda: hist_cuda.grad_hist_ref(
            lb[:, f0:f0 + f_count].contiguous(), ln, lg, lh, n, nb),
            iters=3, warmup=1)
        # the scatter formulation as one library call on the window
        rows = hi - lo
        ids = (ln.long()[:, None] * (f_count * nb)
               + torch.arange(f_count, device=dev)[None, :] * nb
               + lb[:, f0:f0 + f_count].long())
        nseg = n * f_count * nb
        ok = (ln >= 0)[:, None].expand(rows, f_count)
        flat = torch.cat([torch.where(ok, ids, 2 * nseg),
                          torch.where(ok, ids + nseg, 2 * nseg)]).reshape(-1)
        src = torch.cat([lg[:, None].expand(rows, f_count),
                         lh[:, None].expand(rows, f_count)]).reshape(-1)
        acc = torch.zeros(2 * nseg + 1, device=dev)
        res["library_ms"] = cuda_event_ms(lambda: acc.index_add_(0, flat,
                                                                 src),
                                          iters=5, warmup=1)
        live = int((ln >= 0).sum().item())
        nbytes = rows * f_count + 12 * rows + 2 * n * f_count * nb * 4
        res["bound_ms"], res["bound_by"] = _bound_ms(nbytes,
                                                     2 * live * f_count)
        res["bound_bytes"] = nbytes
        return res

    res = _time_serially(rank, alone)
    if res is not None:
        out.update(res)
    return out


def worker_main(mode, outdir):
    """One rank of phase 5 (``--worker gloo|nccl OUTDIR``)."""
    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh, row_range
    from dmlc_core_tpu_torch.utils.timer import device_time

    if mode == "gloo":
        collective.init({"backend": "gloo", "timeout": COLLECTIVE_TIMEOUT_S})
        mesh, n_rows = make_mesh(MESH), N_ROWS
    else:
        collective.init({"timeout": COLLECTIVE_TIMEOUT_S})  # nccl, the card
        if torch.distributed.get_backend() != "nccl":
            fail(f"backend {torch.distributed.get_backend()}, not nccl")
        mesh, n_rows = make_mesh({"data": 1, "model": 1}), N_AGREE
    rank = collective.get_rank()
    dev = torch.device("cuda")
    x, y = make_higgs_like(n_rows, N_FEATURES)
    lo, hi = row_range(mesh, n_rows)
    x, y = x[lo:hi], y[lo:hi]
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    probe = GBDT(GBDTParam(**param), N_FEATURES, model_axis="model")
    bounds = probe.make_bins(x[:QUANTILE_SAMPLE], comm=collective,
                             count=hi - lo)
    bins = torch.from_numpy(HostBinner(bounds, NUM_BINS).transform(x)).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    result = {"rank": rank, "boundaries": bounds, "fits": {},
              "coord": {a: mesh.coord(a) for a in mesh.axis_names}}
    for method in ("pallas", "pallas_fused"):
        model = GBDT(GBDTParam(hist_method=method, **param), N_FEATURES,
                     model_axis="model")
        model.set_boundaries(bounds)
        # the main path: counts set to 0 just before, read just after
        hist_cuda.reset_launches()
        hist_cuda.STAGE_SECONDS = {}
        with mesh:
            (ens, margin), sec = device_time(model.fit_binned, bins, y_t)
        stages, hist_cuda.STAGE_SECONDS = hist_cuda.STAGE_SECONDS, None
        launches = dict(hist_cuda.LAUNCHES)
        if launches["grad_hist_sharded_cuda"] < ROUNDS * MAX_DEPTH:
            fail(f"{method}: K4 launched {launches} times")
        result["fits"][method] = dict(
            ensemble=_ensemble_arrays(ens), seconds=sec, stages=stages,
            launches=launches,
            correct=int(((margin > 0).float() == y_t).sum().item()))
        print(f"rank {rank} {method}: fit {sec:.3f} s, launches {launches}",
              flush=True)
        if mode == "nccl":
            # the same rows and edges without a mesh: the plain card fit
            plain = GBDT(GBDTParam(hist_method=method, **param), N_FEATURES)
            plain.set_boundaries(bounds)
            ref, ref_margin = plain.fit_binned(bins, y_t)
            same = all(torch.equal(a, b) for a, b in zip(ens, ref)) \
                and torch.equal(margin, ref_margin)
            print(f"nccl world 1, {method}: ensemble and margin bitwise "
                  f"equal to the plain card fit: {same}", flush=True)
            if not same:
                fail(f"{method}: the NCCL world-1 fit differs from the "
                     f"plain card fit")
    if mode == "gloo":
        result["k4"] = _k4_check(mesh, rank, lo, hi)
        if rank == 0:
            print(f"K4 at n=32 on rank 0: {json.dumps(result['k4'])}",
                  flush=True)
    torch.save(result, os.path.join(outdir, f"{mode}{rank}.pt"))
    collective.finalize()

# -- phase 6: ingest ----------------------------------------------------------
def _write_text(path, x, y, head, sep, cell):
    """``label<head>v<sep>v...`` lines, every value with %.9g (every
    float32 survives the round trip), written 50,000 rows at a time."""
    fmt = "%.9g" + head + sep.join(cell.format(j) for j in
                                   range(x.shape[1])) + "\n"
    with open(path, "w") as f:
        for s in range(0, len(x), 50_000):
            rows = np.concatenate([y[s:s + 50_000, None], x[s:s + 50_000]],
                                  axis=1).tolist()
            f.write("".join(fmt % tuple(r) for r in rows))
    return os.path.getsize(path)


def _parse_blocks(uri):
    """Every RowBlock of ``uri`` through the port's threaded parser with
    the default thread count; (blocks, seconds)."""
    from dmlc_core_tpu_torch.data.factory import create_parser

    start = time.perf_counter()
    parser = create_parser(uri)
    try:
        blocks = list(parser)
    finally:
        parser.close()
    return blocks, time.perf_counter() - start


def _dense_rows(blocks, n_feature):
    """The real rows of ``dense_batches`` over ``blocks``: (x, y, seconds)."""
    from dmlc_core_tpu_torch.bridge.batching import dense_batches

    start = time.perf_counter()
    xs, ys = [], []
    for b in dense_batches(blocks, INGEST_BATCH, n_feature):
        xs.append(b.x[:b.num_rows].numpy())
        ys.append(b.label[:b.num_rows].numpy())
    return np.concatenate(xs), np.concatenate(ys), time.perf_counter() - start


def _fill(stream, n, dev):
    """The consumer of phase 6's feed: each batch's real rows copied into
    one preallocated [n, F] tensor on the card; (bins, labels, seconds)."""
    bins = torch.empty((n, N_FEATURES), dtype=torch.uint8, device=dev)
    label = torch.empty(n, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    row = 0
    for b in stream:
        k = b.num_rows
        bins[row:row + k] = b.bins[:k]
        label[row:row + k] = b.label[:k]
        row += k
    torch.cuda.synchronize()
    if row != n:
        fail(f"the feed delivered {row} rows, expected {n}")
    return bins, label, time.perf_counter() - start


def _feed(card, binned, n, dev):
    """``DeviceFeedLoader`` (prefetch 2) into the card: a first epoch with
    telemetry on, which times each hand-off's wait, then a warm epoch
    (the pinned ring allocated) with telemetry off, beside synchronous
    pageable ``.to(card)`` copies of the same batches into the same
    consumer.  Returns the warm epoch's bins and labels."""
    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.bridge.binning import BinnedBatch
    from dmlc_core_tpu_torch.bridge.loader import (DeviceFeedLoader,
                                                   batch_nbytes)

    nbytes = sum(batch_nbytes(b) for b in binned)
    loader = DeviceFeedLoader(lambda: iter(binned), prefetch=2)
    telemetry.enable()
    telemetry.reset()
    _, _, cold = _fill(loader, n, dev)
    wait = telemetry.get_registry().counter(
        "dmlc_transfer_seconds_total", path="device_feed",
        phase="wait").value
    telemetry.reset()
    telemetry.disable()
    bins, label, warm = _fill(loader, n, dev)
    _, _, sync = _fill((BinnedBatch(*(t.to(dev) for t in b[:3]),
                                    num_rows=b.num_rows) for b in binned),
                       n, dev)
    print(f"feed of {len(binned)} batches, {nbytes:,} batch bytes: pinned "
          f"ring (prefetch 2) {warm:.4f} s warm, {nbytes / warm / 1e9:.3f} "
          f"GB/s; first epoch with telemetry {cold:.4f} s, non-overlapped "
          f"wait {wait:.4f} s; synchronous pageable .to(card) {sync:.4f} s, "
          f"{nbytes / sync / 1e9:.3f} GB/s [{card}]", flush=True)
    return bins, label


def phase_ingest(card, ref):
    import tempfile

    from dmlc_core_tpu_torch.bridge.binning import HostBinner, binned_batches
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 6: ingest, {N_INGEST:,} libsvm rows and {N_CSV:,} CSV "
          f"rows of phase 4's data -> parser -> batches -> uint8 wire -> "
          f"device feed -> fit_binned", flush=True)
    dev = torch.device("cuda")
    x, y = ref["x"][:N_INGEST], ref["y"][:N_INGEST]
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        svm = os.path.join(tmp, "train.libsvm")
        csv = os.path.join(tmp, "train.csv")
        start = time.perf_counter()
        svm_bytes = _write_text(svm, x, y, " ", " ", "{}:%.9g")
        csv_bytes = _write_text(csv, x[:N_CSV], y[:N_CSV], ",", ",", "%.9g")
        print(f"wrote {svm_bytes:,} bytes of libsvm and {csv_bytes:,} bytes "
              f"of CSV in {time.perf_counter() - start:.2f} s [{card}]",
              flush=True)

        # the ingest path: counts set to 0 just before, read just after
        hist_cuda.reset_launches()
        parsed = {}
        for name, uri, nbytes, rows in (
                ("libsvm", svm, svm_bytes, N_INGEST),
                ("csv", csv + "?format=csv&label_column=0", csv_bytes,
                 N_CSV)):
            blocks, sec = _parse_blocks(uri)
            px, py, dense_sec = _dense_rows(blocks, N_FEATURES)
            print(f"parse {name}: {sec:.3f} s, {nbytes / sec / 1e6:.2f} MB/s, "
                  f"{rows / sec:,.0f} rows/s; dense_batches {dense_sec:.3f} s "
                  f"[{card}]", flush=True)
            if not (np.array_equal(px.view(np.uint32),
                                   x[:rows].view(np.uint32))
                    and np.array_equal(py.view(np.uint32),
                                       y[:rows].view(np.uint32))):
                fail(f"the parsed {name} features or labels are not bitwise "
                     f"the float32 arrays that were written")
            parsed[name] = blocks, px
        print("parsed features and labels bitwise equal to the written "
              "float32 arrays (libsvm and CSV)", flush=True)
        blocks, px = parsed.pop("libsvm")
        del parsed

        param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                     num_bins=NUM_BINS, learning_rate=0.3)
        model = GBDT(GBDTParam(**param), num_feature=N_FEATURES)
        start = time.perf_counter()
        model.make_bins(px[:50_000])
        binner = HostBinner(model.boundaries, NUM_BINS)
        binned = list(binned_batches(blocks, binner, INGEST_BATCH))
        bin_sec = time.perf_counter() - start
        del blocks, px
        wire = np.concatenate([b.bins[:b.num_rows].numpy() for b in binned])
        same_wire = np.array_equal(wire, ref["wire"][:N_INGEST])
        print(f"binning (edges on 50,000 rows, binned_batches): {bin_sec:.3f} "
              f"s [{card}]; wire bitwise equal to phase 4's "
              f"binner.transform: {same_wire}", flush=True)
        if not same_wire:
            fail("the binned_batches wire differs from phase 4's")

        bins, y_dev = _feed(card, binned, N_INGEST, dev)
        want = torch.from_numpy(ref["wire"][:N_INGEST]).to(dev)
        if not torch.equal(bins, want):
            fail("the fed tensor differs from torch.from_numpy(wire).to(card)")
        if not torch.equal(y_dev, ref["y_tr"][:N_INGEST]):
            fail("the fed labels differ from the written labels")
        print("fed tensor bitwise equal to torch.from_numpy(wire).to(card)",
              flush=True)

        (ens, margin), fit_sec = device_time(model.fit_binned, bins, y_dev)
        torch.cuda.synchronize()
        launches = dict(hist_cuda.LAUNCHES)
        print(f"ingest-path fit: {fit_sec:.3f} s [{card}]")
        print(f"phase 6 launches on the ingest path: {launches}", flush=True)
        if launches["grad_hist_fused_cuda"] < ROUNDS * MAX_DEPTH:
            fail(f"the ingest-path fit launched K3's kernel "
                 f"{launches['grad_hist_fused_cuda']} times, expected >= "
                 f"{ROUNDS * MAX_DEPTH}")
        if launches["hist_matmul_cuda"] != 0:
            fail("the ingest-path fit launched K1")
        # the same rows from the in-memory arrays, as phase 4 fits them
        ref_ens, ref_margin = ref["model"].fit_binned(
            ref["bins"][:N_INGEST], ref["y_tr"][:N_INGEST])
        same = (all(torch.equal(a, b) for a, b in zip(ens, ref_ens))
                and torch.equal(margin, ref_margin))
        acc = ((margin > 0).float() == y_dev).float().mean().item()
        print(f"ingest-path fit's ensemble and margin bitwise equal to the "
              f"phase-4 auto fit of the same rows from memory: {same}; train "
              f"acc {acc:.4f}", flush=True)
        if not same:
            fail("the ingest-path fit differs from the in-memory fit")
        del bins, y_dev, want, binned

        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.examples.train_gbdt",
               "--data", svm, "--num-feature", str(N_FEATURES), "--rounds",
               str(ROUNDS), "--max-depth", str(MAX_DEPTH)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        cli_sec = time.perf_counter() - start
        print(proc.stdout.strip())
        if proc.returncode != 0:
            fail(f"the train_gbdt CLI exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        accs = [float(line.rsplit(" ", 1)[1]) for line in
                proc.stdout.splitlines() if "train acc" in line]
        print(f"train_gbdt CLI: exit 0 in {cli_sec:.1f} s, train acc "
              f"{accs} [{card}]", flush=True)
        if not accs or accs[0] < 0.8:
            fail(f"the train_gbdt CLI's train accuracy {accs} < 0.8")
    torch.cuda.empty_cache()


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False")
        sys.path.insert(0, here)
        worker_main(sys.argv[2], sys.argv[3])
        return
    card = phase_device()
    if not os.path.isdir(os.path.join(here, "dmlc_core_tpu_torch")):
        fail(f"no dmlc_core_tpu_torch package beside {__file__}")
    sys.path.insert(0, here)
    phase_build()
    k1, k3 = phase_kernels()
    launches, ref = phase_gbdt(card)
    k1["launches"] = launches["hist_matmul_cuda"]     # 0: K1 is off the path
    k3["launches"] = launches["grad_hist_fused_cuda"]
    k4 = phase_distributed(card)
    phase_ingest(card, ref)
    del ref
    kernels = [k1, k3, dict(
        name="grad_hist_sharded_cuda", route="cuda",
        source="dmlc_core_tpu_torch/csrc/hist.cu",
        replaces="dmlc_core_tpu/ops/hist_pallas.py:350",
        launches=k4["launches"], max_abs_err=k4["max_abs_err"],
        ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=k4["library_ms"])]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
