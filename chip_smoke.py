#!/usr/bin/env python3
"""Drive the PyTorch port's hist-GBDT paths on one CUDA card and check them.

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
   twice with the CLI, would not fit phase 6's ~120 s;
7. serve: phase 4's warm ``"auto"`` model is saved with ``serving_state``
   through ``CheckpointManager.save(1)`` (manifest published) under
   ``build/chip_smoke_serve/``, loaded with ``build_runtime("gbdt", 28,
   checkpoint=...)`` on the card (its ``predict_float`` on 8,192 held-out
   rows within 1e-6 of the CPU plain version from the same blob) and
   served by a ``ScoringServer`` on 127.0.0.1, port 0 (``max_batch`` 64,
   ``max_delay_ms`` 2) with a ``CheckpointWatcher`` on the directory.
   Eight client threads, each on a keep-alive connection, send 1,000
   requests of 1-64 of those rows (latency p50/p95/p99, requests/s and
   rows/s printed); then they keep sending while 2 rounds are appended on
   the card (``append_rounds``, K3's kernel) and published as step 2,
   until 500 answers came from step 2 (about 1,500 requests in all: at
   the ~50 requests/s the card's scoring path serves, 2,000 would not fit
   the phase's ~40 s).  Every answer must be 200 and bitwise the
   ``predict_float`` of the version that answered it, both versions must
   answer, ``/healthz`` must report version 2 (the seconds from publish
   to the first step-2 answer printed), a 27-wide row must get the
   structured 400, and step 2's ``predict_float`` must be within 1e-6 of
   the CPU plain version from its blob.  It prints the warmup seconds and
   the direct ``predict`` time of 64 and 65,536 rows, builds the seeded
   ``build_runtime("gbdt", 28)`` (a 256-row fit on the card), drains the
   server and reads the K3 launches of the phase (>= 12 + 24).  Last,
   ``python -m dmlc_core_tpu_torch.serve --model gbdt --checkpoint
   <step 1> --num-feature 28 --port 0`` as a subprocess: the ``serving
   ... on <url>`` line, one POST bitwise equal to the in-process step-1
   answer, SIGTERM, and ``serve: shut down cleanly`` with exit 0;
8. train: (8a) ``fit_with_eval`` on phase 4's 2,000,000 rows with its
   200,000 held-out rows: 10 rounds bitwise phase 4's ``"auto"`` fit, each
   round's eval loss within 1e-6 of ``staged_losses``; 40 rounds, then
   40 with ``early_stopping_rounds=3`` (on ``loss`` and on ``error`` at
   learning rate 0.3, on ``loss`` at 1.5 and 2, which overshoot, so at
   least one fit must stop early), whose kept trees must be bitwise the
   first ``best_round + 1`` of the 40;
   (8b) ``GBDTClassifier(device="cuda")`` on the 2,000,000 raw rows:
   held-out accuracy >= 0.8, ``feature_importances_`` summing to 1,
   ``save_model`` -> ``load_model`` with bitwise ``predict_proba``; (8c)
   a ``TrainerDaemon`` on the card over a spool of 8 libsvm files of
   31,250 of phase 4's rows (2 rounds a batch, a publish every 4 rounds,
   a ``_DONE`` sentinel; at 62,500 rows a file the phase took 80 s on an
   H100), its steps served live by a ``ScoringServer`` with a
   ``CheckpointWatcher`` while 8 client threads send requests (the spool
   hands out the next batch only after the newest step answered 20 of
   them): every answer 200 and bitwise the ``predict_float`` of its
   version, at least 3 versions, the final step 16 trees at cursor 8; the
   seconds of parsing, binning, rounds, the margin recompute and
   publishing, rounds/s, and publish -> first answer of each step; (8d)
   ``python -m dmlc_core_tpu_torch.train`` over the same spool, killed by
   a ``DMLC_FAULT_PLAN`` exit 43 at ``train.round`` after 9 rounds, then
   rerun as ``--incarnation 1`` with one torn publish: it must resume
   from step 2, count one rejection, finish, and end bitwise equal to
   8c's final step; (8e) a port ``ShardLeaseCoordinator`` over 200,000
   libsvm rows in 8 units feeding one daemon through ``FleetSource``:
   every unit committed once, 200,000 rows trained.  Each part counts
   K3's launches (6 a round) and K1's (none).

The line before the last is a JSON object with one entry per kernel (K1,
K3, K4; K2 has no kernel of its own).  Each ``launches`` is the count of
the main path's run (phase 4 for K1 and K3, phase 5 for K4), with the
counts set to 0 just before it: K1 is on no main path, so its count is 0
(phase 3 prints its launches there on a line of their own, and phase 6
those of the ingest path, phase 7 those of the serving path and phase 8
those of the training paths).  The last line is ``{"ok": true,
"device": {...}}``.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
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
SERVE_POOL = 8192             # phase 7's held-out rows the requests draw on
SERVE_REQUESTS = 1000         # per wave; wave 2 runs on through the swap
SERVE_CLIENTS = 8
SERVE_MAX_BATCH = 64
SERVE_APPEND_ROUNDS = 2
EVAL_ROUNDS = 40              # phase 8a's early-stopping fits
EVAL_PATIENCE = 3
TRAIN_FILES = 8               # phase 8's spool: 8 libsvm files of
TRAIN_FILE_ROWS = 31_250      # 31,250 of phase 4's rows (250,000 rows;
                              # 500,000 took phase 8 to 80 s on an H100)
TEXT_CHUNK = 6_250            # rows formatted at a time
TRAIN_ROUNDS_PER_BATCH = 2
TRAIN_PUBLISH_ROUNDS = 4
TRAIN_GATE_ANSWERS = 20       # answers of a step before the next batch
TRAIN_FINAL_ANSWERS = 50      # answers of the last step before the stop
FLEET_ROWS = 200_000          # phase 8e's corpus
FLEET_UNITS = 8
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
    ref = dict(x=x, y=y, wire=wire, model=model, bins=bins, y_tr=y_tr,
               ens=fits[1][0])
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


# -- phase 7: serve ------------------------------------------------------------
class _Client:
    """One keep-alive HTTP connection, as a scoring client holds one."""

    def __init__(self, url):
        import http.client
        from urllib.parse import urlparse

        u = urlparse(url)
        self._conn = http.client.HTTPConnection(u.hostname, u.port,
                                                timeout=60)

    def post(self, path, body):
        self._conn.request("POST", path, body=body,
                           headers={"Content-Type": "application/json"})
        resp = self._conn.getresponse()
        return resp.status, json.loads(resp.read())

    def get(self, path):
        self._conn.request("GET", path)
        resp = self._conn.getresponse()
        return resp.status, json.loads(resp.read())

    def close(self):
        self._conn.close()


def _wave(url, pool, rng, stop_after=None, on_answer=None):
    """Requests of 1-64 pool rows from SERVE_CLIENTS threads, each on its
    own keep-alive connection: ``stop_after`` of them, or until
    ``on_answer(reply)`` returns True.  Returns (answers, wall seconds);
    each answer is (status, body, row ids, sent, received) on the host
    clock."""
    answers = []
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def client():
        conn = _Client(url)
        try:
            while not stop.is_set():
                with lock:
                    if stop_after is not None and \
                            len(answers) + in_flight[0] >= stop_after:
                        return
                    in_flight[0] += 1
                    idx = rng.randint(0, len(pool),
                                      rng.randint(1, SERVE_MAX_BATCH + 1))
                body = json.dumps({"instances": pool[idx].tolist()})
                sent = time.perf_counter()
                status, reply = conn.post("/v1/score", body)
                got = time.perf_counter()
                with lock:
                    in_flight[0] -= 1
                    answers.append((status, reply, idx, sent, got))
                    if on_answer is not None and on_answer(reply):
                        stop.set()
        except Exception as exc:        # surfaced by the caller's fail()
            errors.append(repr(exc))
            stop.set()
        finally:
            conn.close()

    in_flight = [0]
    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - start
    if errors or any(t.is_alive() for t in threads):
        fail(f"phase 7 clients failed: {errors[:3]}")
    return answers, wall


def _check_answers(answers, want, label):
    """Every answer 200 and bitwise the predict_float scores of the
    version that answered it; returns the versions seen."""
    versions = set()
    for status, reply, idx, _, _ in answers:
        if status != 200:
            fail(f"{label}: a request answered {status}: {reply}")
        v = reply.get("version")
        if v not in want:
            fail(f"{label}: an answer from unknown version {v!r}")
        got = np.asarray(reply["predictions"], np.float32)
        if not np.array_equal(got.view(np.uint32),
                              want[v][idx].view(np.uint32)):
            fail(f"{label}: an answer of version {v} is not bitwise that "
                 f"version's predict_float")
        versions.add(v)
    return versions


def _latency_line(answers, wall, label, card):
    lat = np.array([got - sent for _, _, _, sent, got in answers]) * 1e3
    rows = sum(len(idx) for _, _, idx, _, _ in answers)
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    print(f"{label}: {len(answers)} requests, latency p50 {p50:.3f} ms, "
          f"p95 {p95:.3f} ms, p99 {p99:.3f} ms; {len(answers) / wall:.1f} "
          f"requests/s, {rows / wall:.0f} rows/s [{card}]", flush=True)


def _predict_ms(runtime, rows, reps):
    """Median milliseconds of one synchronous ``predict`` (host binning,
    transfer, trees, scores back on the host)."""
    times = []
    for _ in range(reps + 1):
        start = time.perf_counter()
        runtime.predict(rows)
        times.append(time.perf_counter() - start)
    return 1e3 * float(np.median(times[1:]))


def phase_serve(card, ref):
    from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                       load_checkpoint)
    from dmlc_core_tpu_torch.models.gbdt import GBDT
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.serve import (CheckpointWatcher, GBDTRuntime,
                                           ModelRegistry, ScoringServer,
                                           build_runtime, runtime_builder)

    print(f"== phase 7: serve the phase-4 model ({N_FEATURES} features, "
          f"{NUM_BINS} bins, depth {MAX_DEPTH}, {ROUNDS} rounds) over HTTP "
          f"from a checkpoint, hot-swap {SERVE_APPEND_ROUNDS} appended "
          f"rounds, then the CLI", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(here, "build", "chip_smoke_serve")
    shutil.rmtree(directory, ignore_errors=True)
    model, ens = ref["model"], ref["ens"]
    pool = ref["x"][N_ROWS:N_ROWS + SERVE_POOL]
    rng = np.random.RandomState(7)
    mgr = CheckpointManager(directory, keep=5)

    # the serving path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    mgr.save(1, model.serving_state(ens), async_=False)
    uri1 = mgr.step_uri(1)
    runtime = build_runtime("gbdt", N_FEATURES, checkpoint=uri1)
    if runtime.gbdt.device.type != "cuda":
        fail(f"build_runtime served on {runtime.gbdt.device}, not cuda")
    want = {1: runtime.predict_float(pool)}
    plain, plain_ens = GBDT.from_serving_state(load_checkpoint(uri1),
                                               device="cpu")
    cpu = plain.predict(plain_ens, plain.bin_features(pool)).numpy()
    err = float(np.abs(cpu - want[1]).max())
    print(f"step 1 blob {os.path.getsize(uri1):,} bytes; predict_float on "
          f"the card vs the CPU plain version on {SERVE_POOL} rows: max abs "
          f"err {err:.3g}", flush=True)
    if err > 1e-6:
        fail(f"the card's predict_float differs from the CPU plain version "
             f"by {err:.3g} > 1e-6")
    registry = ModelRegistry()
    registry.add("gbdt", runtime, version=1, max_batch=SERVE_MAX_BATCH,
                 max_delay_ms=2.0, default=True)
    server = ScoringServer(registry, host="127.0.0.1", port=0)
    start = time.perf_counter()
    server.start()
    warm_s = time.perf_counter() - start
    watcher = CheckpointWatcher(registry, "gbdt", directory,
                                runtime_builder("gbdt", N_FEATURES),
                                poll_s=0.05, manager=mgr)
    watcher.start()
    try:
        print(f"warmup (bucket ladder {registry.get().batcher.buckets}) and "
              f"start: {warm_s:.3f} s [{card}]", flush=True)
        answers, wall = _wave(server.url, pool, rng,
                              stop_after=SERVE_REQUESTS)
        _check_answers(answers, want, "wave 1")
        _latency_line(answers, wall, f"wave 1 ({SERVE_CLIENTS} clients, "
                      f"1-{SERVE_MAX_BATCH} rows each, max_batch "
                      f"{SERVE_MAX_BATCH}, max_delay_ms 2)", card)

        # wave 2: the clients keep sending while 2 rounds are appended on
        # the card and published as step 2
        swap = {}

        def trainer():
            try:
                ens2, _ = model.append_rounds(
                    ens, ref["bins"], ref["y_tr"],
                    num_rounds=SERVE_APPEND_ROUNDS)
                want[2] = GBDTRuntime(model, ens2).predict_float(pool)
                swap["publish"] = time.perf_counter()
                mgr.save(2, model.serving_state(ens2), async_=False)
            except Exception as exc:    # surfaced by fail() below
                swap["error"] = repr(exc)

        seen_v2 = [0]
        wave_start = time.perf_counter()

        def swapped_and_settled(reply):
            # stop at the 500th answer from step 2 (or when the trainer
            # failed, or after 120 s, which fail below)
            seen_v2[0] += reply.get("version") == 2
            return (seen_v2[0] >= 500 or "error" in swap
                    or time.perf_counter() - wave_start > 120)

        t = threading.Thread(target=trainer)
        t.start()
        answers2, _ = _wave(server.url, pool, rng,
                            on_answer=swapped_and_settled)
        t.join(300)
        if "publish" not in swap:
            fail(f"appending rounds for step 2 failed: {swap.get('error')}")
        versions = _check_answers(answers2, want, "wave 2")
        first2 = min(got for _, reply, _, _, got in answers2
                     if reply.get("version") == 2)
        print(f"wave 2 through the hot swap: {len(answers2)} requests, all "
              f"200, versions {sorted(versions)}; every answer bitwise its "
              f"version's predict_float; publish -> first step-2 answer "
              f"{first2 - swap['publish']:.3f} s (swap cycle "
              f"{watcher.swaps_completed} ok, {watcher.rejections} "
              f"rejected) [{card}]", flush=True)
        if versions != {1, 2} or watcher.rejections:
            fail(f"the hot swap did not serve both versions cleanly: "
                 f"{sorted(versions)}, {watcher.rejections} rejections")
        plain, plain_ens = GBDT.from_serving_state(
            load_checkpoint(mgr.step_uri(2)), device="cpu")
        cpu = plain.predict(plain_ens, plain.bin_features(pool)).numpy()
        err = float(np.abs(cpu - want[2]).max())
        print(f"step 2: predict_float on the card vs the CPU plain version "
              f"from its blob: max abs err {err:.3g}", flush=True)
        if err > 1e-6:
            fail(f"step 2's predict_float differs from the CPU plain "
                 f"version by {err:.3g} > 1e-6")
        conn = _Client(server.url)
        try:
            status, health = conn.get("/healthz")
            bad_status, bad = conn.post(
                "/v1/score", json.dumps(
                    {"instances": [[0.0] * (N_FEATURES - 1)]}))
        finally:
            conn.close()
        print(f"/healthz after the swap: status {health['status']}, "
              f"version {health['version']}; a {N_FEATURES - 1}-wide row: "
              f"{bad_status} {bad}", flush=True)
        if status != 200 or health["version"] != 2:
            fail(f"/healthz after the swap: {status} {health}")
        if bad_status != 400 or bad.get("error", {}).get("code") \
                != "bad_request":
            fail(f"a wrong-width request got {bad_status} {bad}")
        live = registry.get().runtime
        small, large = pool[:64], ref["x"][N_ROWS:N_ROWS + 65_536]
        print(f"direct predict of the step-2 model: 64 rows "
              f"{_predict_ms(live, small, 20):.3f} ms, 65,536 rows "
              f"{_predict_ms(live, large, 5):.3f} ms [{card}]", flush=True)
        seeded = build_runtime("gbdt", N_FEATURES, seed=0)
        if not np.isfinite(seeded.predict(small)).all():
            fail("the seeded runtime's scores are not finite")
    finally:
        watcher.close()
        server.drain(timeout_s=30, settle_s=0.1)
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)
    need = SERVE_APPEND_ROUNDS * MAX_DEPTH + 8 * 3
    print(f"phase 7 launches on the serving path (the appended rounds and "
          f"the seeded runtime's fit): {launches}", flush=True)
    if launches["grad_hist_fused_cuda"] < need:
        fail(f"phase 7 launched K3's kernel "
             f"{launches['grad_hist_fused_cuda']} times, expected >= {need}")

    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.serve", "--model",
           "gbdt", "--checkpoint", uri1, "--num-feature", str(N_FEATURES),
           "--port", "0"]
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    # a CLI that hangs before its first line must not hang the phase
    killer = threading.Timer(CLI_TIMEOUT_S, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving gbdt on http://"):
            proc.kill()
            fail(f"the serve CLI printed {line!r}: "
                 f"{proc.communicate()[1][-3000:]}")
        up_s = time.perf_counter() - start
        url = line.split(" on ", 1)[1].split()[0]
        idx = np.arange(17)
        conn = _Client(url)
        try:
            status, reply = conn.post("/v1/score", json.dumps(
                {"instances": pool[idx].tolist()}))
        finally:
            conn.close()
        got = np.asarray(reply.get("predictions", []), np.float32)
        same = status == 200 and np.array_equal(
            got.view(np.uint32), want[1][idx].view(np.uint32))
        proc.send_signal(signal.SIGTERM)
        out, err_text = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"serve CLI: up in {up_s:.1f} s; one POST of 17 rows {status}, "
          f"bitwise the in-process step-1 answer: {same}; exit "
          f"{proc.returncode}, {out.strip().splitlines()[-1:]} [{card}]",
          flush=True)
    if not same:
        fail(f"the serve CLI answered {status} {reply}")
    if proc.returncode != 0 or "serve: shut down cleanly" not in out:
        fail(f"the serve CLI did not shut down cleanly: {err_text[-3000:]}")
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()


# -- phase 8: train ------------------------------------------------------------
def _k3_launches():
    from dmlc_core_tpu_torch.ops import hist_cuda

    torch.cuda.synchronize()
    return hist_cuda.LAUNCHES["grad_hist_fused_cuda"]


def _check_k3(label, want):
    """Exactly ``want`` K3 launches since the last reset, and K1 none."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    got = _k3_launches()
    print(f"{label}: {got} K3 launches (6 a round), K1 "
          f"{hist_cuda.LAUNCHES['hist_matmul_cuda']}", flush=True)
    if got != want or hist_cuda.LAUNCHES["hist_matmul_cuda"]:
        fail(f"{label}: K3 launched {got} times, expected {want} (K1 "
             f"{hist_cuda.LAUNCHES['hist_matmul_cuda']})")
    return got


def _fit_with_eval(card, ref):
    """8a: ``fit_with_eval`` on phase 4's rows with its held-out rows."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    dev = torch.device("cuda")
    held = torch.from_numpy(ref["wire"][N_ROWS:]).to(dev)
    y_te = torch.from_numpy(ref["y"][N_ROWS:]).to(dev)
    param = dict(max_depth=MAX_DEPTH, num_bins=NUM_BINS)

    def model(rounds, lr=0.3):
        m = GBDT(GBDTParam(num_boost_round=rounds, learning_rate=lr,
                           **param), N_FEATURES)
        m.set_boundaries(ref["model"].boundaries)
        return m

    m10 = model(ROUNDS)
    hist_cuda.reset_launches()
    (ens, hist), sec = device_time(m10.fit_with_eval, ref["bins"],
                                   ref["y_tr"], held, y_te)
    same = all(torch.equal(a, b) for a, b in zip(ens, ref["ens"]))
    curve = m10.staged_losses(ens, held, y_te)
    err = max(abs(float(c) - h["eval_loss"]) for c, h in zip(curve, hist))
    print(f"8a fit_with_eval, {ROUNDS} rounds on {N_ROWS:,} rows, eval on "
          f"{N_HELDOUT:,}: {sec:.3f} s [{card}]; ensemble bitwise equal to "
          f"phase 4's auto fit: {same}; eval loss {hist[0]['eval_loss']:.5f}"
          f" -> {hist[-1]['eval_loss']:.5f}, max |eval_loss - "
          f"staged_losses| {err:.3g}", flush=True)
    if not same:
        fail("fit_with_eval's ensemble differs from phase 4's auto fit")
    if len(hist) != ROUNDS or err > 1e-6:
        fail(f"fit_with_eval's history ({len(hist)} rounds) disagrees with "
             f"staged_losses by {err:.3g} > 1e-6")
    launches = ROUNDS * MAX_DEPTH
    # learning rates 1.5 and 2 overshoot, so the eval loss stops falling
    # within 40 rounds and the stopping rule truncates
    truncated = 0
    for lr, metrics in ((0.3, ("loss", "error")), (1.5, ("loss",)),
                        (2.0, ("loss",))):
        m40 = model(EVAL_ROUNDS, lr)
        (full, full_hist), sec = device_time(m40.fit_with_eval, ref["bins"],
                                             ref["y_tr"], held, y_te)
        launches += EVAL_ROUNDS * MAX_DEPTH
        print(f"8a {EVAL_ROUNDS} rounds at learning rate {lr} without early "
              f"stopping: {sec:.3f} s [{card}]", flush=True)
        for metric in metrics:
            (stop, stop_hist), sec = device_time(
                m40.fit_with_eval, ref["bins"], ref["y_tr"], held, y_te,
                early_stopping_rounds=EVAL_PATIENCE, eval_metric=metric)
            launches += len(stop_hist) * MAX_DEPTH
            kept = stop.num_trees
            truncated += kept < EVAL_ROUNDS
            same = all(torch.equal(a, b[:kept]) for a, b in zip(stop, full))
            if metric == "loss":
                same = same and [h["eval_loss"] for h in stop_hist] == \
                    [h["eval_loss"] for h in full_hist[:len(stop_hist)]]
            print(f"8a early stopping (learning rate {lr}, eval_metric "
                  f"{metric!r}, patience {EVAL_PATIENCE}): {len(stop_hist)} "
                  f"rounds run, best round {kept - 1}, {sec:.3f} s [{card}]; "
                  f"the kept trees bitwise the first {kept} of the "
                  f"{EVAL_ROUNDS}-round fit: {same}", flush=True)
            if not same:
                fail(f"early stopping ({lr}, {metric}) kept trees that "
                     f"differ from the uninterrupted fit's")
    if not truncated:
        fail("no early-stopping fit stopped within 40 rounds")
    _check_k3("8a launches", launches)


def _classifier(card, ref, tmp):
    """8b: the sklearn facade on the card at full width."""
    from dmlc_core_tpu_torch.models.sklearn import GBDTClassifier
    from dmlc_core_tpu_torch.ops import hist_cuda

    x, y = ref["x"], ref["y"]
    hist_cuda.reset_launches()
    clf = GBDTClassifier(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                         num_bins=NUM_BINS, learning_rate=0.3,
                         device="cuda")
    start = time.perf_counter()
    clf.fit(x[:N_ROWS], y[:N_ROWS])
    torch.cuda.synchronize()
    sec = time.perf_counter() - start
    if clf.model_.device.type != "cuda":
        fail(f"GBDTClassifier trained on {clf.model_.device}")
    acc = clf.score(x[N_ROWS:], y[N_ROWS:])
    imp = clf.feature_importances_
    path = os.path.join(tmp, "classifier.bin")
    clf.save_model(path)
    loaded = GBDTClassifier.load_model(path, device="cuda")
    proba = clf.predict_proba(x[N_ROWS:])
    same = np.array_equal(loaded.predict_proba(x[N_ROWS:]), proba)
    print(f"8b GBDTClassifier(device='cuda').fit on {N_ROWS:,} raw rows "
          f"(edges, binning, {ROUNDS} rounds): {sec:.3f} s [{card}]; "
          f"held-out accuracy {acc:.4f}; feature_importances_ sum "
          f"{imp.sum():.9f}; save_model -> load_model predict_proba bitwise "
          f"equal: {same}", flush=True)
    if acc < 0.8:
        fail(f"GBDTClassifier held-out accuracy {acc:.4f} < 0.8")
    if abs(imp.sum() - 1.0) > 1e-6 or (imp < 0).any():
        fail(f"feature_importances_ sum {imp.sum()}")
    if not same or proba.shape != (N_HELDOUT, 2):
        fail("the loaded classifier's predict_proba differs")
    _check_k3("8b launches", ROUNDS * MAX_DEPTH)


class _Timed:
    """Seconds spent in wrapped calls (the card synchronized around each
    unless ``sync=False``), and each call's (result, end time)."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}

    def wrap(self, name, fn, sync=True):
        def timed(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            end = time.perf_counter()
            self.seconds[name] = self.seconds.get(name, 0.0) + end - start
            self.calls.setdefault(name, []).append((out, end))
            return out
        return timed


class _Paced:
    """The spool source, paced by the server: the next batch is handed out
    only once the newest published step has answered ``TRAIN_GATE_ANSWERS``
    requests, so every step serves before the next replaces it."""

    def __init__(self, inner, seen, lock):
        self.inner = inner
        self.seen = seen
        self.lock = lock
        self.daemon = None

    def next_batch(self, cursor):
        published = self.daemon.publishes_completed
        with self.lock:
            ready = published == 0 or \
                self.seen.get(published, 0) >= TRAIN_GATE_ANSWERS
        return self.inner.next_batch(cursor) if ready else None

    def exhausted(self, cursor):
        return self.inner.exhausted(cursor)


def _train_param():
    from dmlc_core_tpu_torch.models.gbdt import GBDTParam

    return GBDTParam(max_depth=MAX_DEPTH, num_bins=NUM_BINS,
                     learning_rate=0.3)


def _final_step(directory):
    from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                       load_checkpoint)

    mgr = CheckpointManager(directory)
    step, _ = mgr.latest_valid(verify=True)
    if step is None:
        fail(f"no valid step under {directory}")
    return step, load_checkpoint(mgr.step_uri(step))


def _daemon_in_process(card, ref, spool, ckpt):
    """8c: the daemon on the card over the spool, its steps served live."""
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.serve import (CheckpointWatcher, ModelRegistry,
                                           ScoringServer, build_runtime,
                                           runtime_builder)
    from dmlc_core_tpu_torch.train import DirectorySource, TrainerDaemon

    seen, lock = {}, threading.Lock()
    source = _Paced(DirectorySource(spool, N_FEATURES), seen, lock)
    daemon = TrainerDaemon(ckpt, source, N_FEATURES, param=_train_param(),
                           rounds_per_batch=TRAIN_ROUNDS_PER_BATCH,
                           publish_every_rounds=TRAIN_PUBLISH_ROUNDS,
                           poll_s=0.05)
    source.daemon = daemon
    timer = _Timed()
    source.inner.next_batch = timer.wrap("parse", source.inner.next_batch,
                                         sync=False)
    daemon._train_on = timer.wrap("train", daemon._train_on)
    daemon._gbdt.predict_margin = timer.wrap("predict",
                                             daemon._gbdt.predict_margin)
    daemon._gbdt.bin_features = timer.wrap("binning",
                                           daemon._gbdt.bin_features)
    daemon.publish_now = timer.wrap("publish", daemon.publish_now)
    errors = []

    def run():
        try:
            daemon.run(exit_when_idle=True)
        except Exception as exc:      # surfaced by fail() below
            errors.append(repr(exc))

    # the training path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    start = time.perf_counter()
    # a daemon thread: a run that fails below must not hang the exit
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    while daemon.publishes_completed == 0 and thread.is_alive():
        time.sleep(0.01)
    if errors or daemon.publishes_completed == 0:
        fail(f"the daemon published nothing: {errors}")
    mgr = daemon.manager
    registry = ModelRegistry()
    registry.add("gbdt", build_runtime("gbdt", N_FEATURES,
                                       checkpoint=mgr.step_uri(1)),
                 version=1, max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0,
                 default=True)
    server = ScoringServer(registry, host="127.0.0.1", port=0)
    server.start()
    watcher = CheckpointWatcher(registry, "gbdt", ckpt,
                                runtime_builder("gbdt", N_FEATURES),
                                poll_s=0.05, manager=mgr)
    watcher.start()
    pool = ref["x"][N_ROWS:N_ROWS + SERVE_POOL]
    last = TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH // TRAIN_PUBLISH_ROUNDS

    def counted(reply):
        v = reply.get("version")
        with lock:
            seen[v] = seen.get(v, 0) + 1
            done = seen.get(last, 0) >= TRAIN_FINAL_ANSWERS
        return (done or bool(errors)
                or time.perf_counter() - start > 180)

    try:
        answers, _ = _wave(server.url, pool, np.random.RandomState(8),
                           on_answer=counted)
        thread.join(300)
    finally:
        watcher.close()
        server.drain(timeout_s=30, settle_s=0.1)
    if errors or thread.is_alive():
        fail(f"the daemon failed: {errors}")
    sec = time.perf_counter() - start
    state = daemon.describe()
    steps = mgr.all_steps()
    want = {v: build_runtime("gbdt", N_FEATURES,
                             checkpoint=mgr.step_uri(v)).predict_float(pool)
            for v in steps}
    versions = _check_answers(answers, want, "8c")
    firsts = {}
    for _, reply, _, _, got in answers:
        v = reply["version"]
        firsts[v] = min(firsts.get(v, got), got)
    # publish_now returns the step it published, None when nothing was new
    swap = {step: firsts[step] - end for step, end in timer.calls["publish"]
            if step is not None and step in firsts and step > 1}
    step, flat = _final_step(ckpt)
    trees = np.asarray(flat["['split_feat']"]).shape[0]
    cursor = int(np.asarray(flat["['train_cursor']"])[0])
    t = timer.seconds
    rounds_s = t["train"] - t["predict"] - t["binning"]
    rate = state["rounds_completed"] / rounds_s
    print(f"8c daemon over {TRAIN_FILES} files x {TRAIN_FILE_ROWS:,} rows "
          f"({TRAIN_ROUNDS_PER_BATCH} rounds a batch, publish every "
          f"{TRAIN_PUBLISH_ROUNDS} rounds), served live: {sec:.2f} s in all "
          f"[{card}]; parse {t['parse']:.3f} s, binning {t['binning']:.3f} "
          f"s, rounds {rounds_s:.3f} s ({rate:.1f} rounds/s), predict "
          f"(margin recompute) {t['predict']:.3f} s, publish "
          f"{t['publish']:.3f} s", flush=True)
    print(f"8c steps {steps}, final step {step}: {trees} trees, cursor "
          f"{cursor}; {len(answers)} answers, all 200 and bitwise the "
          f"predict_float of their version; versions {sorted(versions)}; "
          f"publish -> first answer of the new version "
          f"{ {k: round(v, 3) for k, v in sorted(swap.items())} } s "
          f"({watcher.swaps_completed} swaps, {watcher.rejections} "
          f"rejected) [{card}]", flush=True)
    if len(versions) < 3 or watcher.rejections:
        fail(f"8c: versions {sorted(versions)} answered, "
             f"{watcher.rejections} swaps rejected")
    if trees != TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH or \
            cursor != TRAIN_FILES or state["quarantined"]:
        fail(f"8c: the final step holds {trees} trees at cursor {cursor} "
             f"({state})")
    _check_k3("8c launches",
              TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH * MAX_DEPTH)
    return flat


def _daemon_cli(card, spool, ckpt, state_file, want):
    """8d: the CLI on the card, killed mid-round and resumed."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.train", "--data", spool,
           "--ckpt", ckpt, "--num-feature", str(N_FEATURES),
           "--rounds-per-batch", str(TRAIN_ROUNDS_PER_BATCH),
           "--publish-every-rounds", str(TRAIN_PUBLISH_ROUNDS),
           "--max-depth", str(MAX_DEPTH), "--num-bins", str(NUM_BINS),
           "--learning-rate", "0.3", "--poll-s", "0.05", "--exit-when-idle",
           "--state-file", state_file]
    kill = {"rules": [{"site": "train.round", "kind": "exit", "code": 43,
                       "match": {"incarnation": "0"}, "after": 9,
                       "times": 1}]}
    tear = {"rules": [{"site": "train.publish", "kind": "truncate",
                       "keep": 64, "match": {"phase": "durable"},
                       "times": 1}]}
    runs = []
    for extra, plan in (([], kill), (["--incarnation", "1"], tear)):
        env = dict(os.environ, DMLC_FAULT_PLAN=json.dumps(plan))
        start = time.perf_counter()
        proc = subprocess.run(cmd + extra, cwd=here, env=env,
                              capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        with open(state_file) as f:
            runs.append((proc, time.perf_counter() - start, json.load(f)))
    (killed, k_sec, k_state), (resumed, r_sec, r_state) = runs
    print(f"8d CLI killed at train.round after 9 rounds: exit "
          f"{killed.returncode} in {k_sec:.1f} s, state {k_state}; resumed "
          f"(--incarnation 1, one torn publish): exit {resumed.returncode} "
          f"in {r_sec:.1f} s, state {r_state} [{card}]", flush=True)
    if killed.returncode != 43:
        fail(f"the killed CLI exited {killed.returncode}: "
             f"{killed.stderr[-3000:]}")
    if resumed.returncode != 0:
        fail(f"the resumed CLI exited {resumed.returncode}: "
             f"{resumed.stderr[-3000:]}")
    if (r_state["resumed_from"] != 2 or r_state["publish_rejections"] != 1
            or r_state["cursor"] != TRAIN_FILES
            or r_state["trees"] != TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH):
        fail(f"the resumed CLI's state {r_state}")
    _, flat = _final_step(ckpt)
    same = sorted(flat) == sorted(want) and all(
        np.array_equal(np.asarray(flat[k]), np.asarray(want[k]))
        for k in want)
    print(f"8d final ensemble bitwise equal to 8c's: {same}", flush=True)
    if not same:
        fail("the killed-and-resumed CLI's final step differs from 8c's")


def _fleet(card, path, ckpt):
    """8e: a port coordinator over a libsvm corpus and one daemon fed from
    it through ``FleetSource``."""
    from dmlc_core_tpu_torch.parallel.fleet_ingest import plan_units
    from dmlc_core_tpu_torch.tracker.rendezvous import ShardLeaseCoordinator
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.train import FleetSource, TrainerDaemon

    units = plan_units(path, 1, num_units=FLEET_UNITS, fmt="libsvm")
    coord = ShardLeaseCoordinator("127.0.0.1", units)
    hist_cuda.reset_launches()
    start = time.perf_counter()
    coord.start()
    rows = []
    try:
        source = FleetSource("w0", N_FEATURES, host="127.0.0.1",
                             port=coord.port).start()
        inner = source.next_batch

        def counting(cursor):
            batch = inner(cursor)
            if batch is not None:
                rows.append(len(batch.label))
            return batch

        source.next_batch = counting
        daemon = TrainerDaemon(ckpt, source, N_FEATURES,
                               param=_train_param(), rounds_per_batch=1,
                               publish_every_rounds=TRAIN_PUBLISH_ROUNDS,
                               poll_s=0.05)
        daemon.run(exit_when_idle=True)
        ledger = coord.result(timeout=60)
    finally:
        coord.stop()
    sec = time.perf_counter() - start
    state = daemon.describe()
    once = (len(ledger) == FLEET_UNITS
            and coord.committed_total == FLEET_UNITS
            and all(e["assigned"] == 1 for e in ledger.values())
            and coord.rejected_total == 0)
    committed = sum(e["rows"] for e in ledger.values())
    print(f"8e FleetSource over {FLEET_ROWS:,} rows in {FLEET_UNITS} units: "
          f"{sec:.2f} s [{card}]; every unit committed once: {once}; rows "
          f"committed {committed:,}, trained {sum(rows):,}; state {state}",
          flush=True)
    if not once or committed != FLEET_ROWS or sum(rows) != FLEET_ROWS:
        fail(f"8e: coverage {len(ledger)} units, {committed} committed "
             f"rows, {sum(rows)} trained rows")
    if state["rounds_completed"] != FLEET_UNITS or state["trees"] != \
            FLEET_UNITS:
        fail(f"8e: the daemon's state {state}")
    _check_k3("8e launches", FLEET_UNITS * MAX_DEPTH)


def phase_train(card, ref):
    import tempfile

    print(f"== phase 8: train: fit_with_eval and early stopping, the sklearn "
          f"facade, the continuous trainer over a spool of {TRAIN_FILES} x "
          f"{TRAIN_FILE_ROWS:,} rows (in process, served live; then the CLI "
          f"killed and resumed) and over the lease fleet", flush=True)
    phase_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _fit_with_eval(card, ref)
        _classifier(card, ref, tmp)
        spool = os.path.join(tmp, "spool")
        os.makedirs(spool)
        start = time.perf_counter()
        # the text of each TEXT_CHUNK rows once: the spool's files and the
        # fleet corpus (its first rows) are made of the same chunks
        n = TRAIN_FILES * TRAIN_FILE_ROWS
        fmt = "%.9g " + " ".join(f"{j}:%.9g" for j in range(N_FEATURES)) \
            + "\n"
        chunks = ["".join(fmt % tuple(r) for r in np.concatenate(
            [ref["y"][lo:lo + TEXT_CHUNK, None],
             ref["x"][lo:lo + TEXT_CHUNK]], axis=1).tolist())
            for lo in range(0, max(n, FLEET_ROWS), TEXT_CHUNK)]
        per_file = TRAIN_FILE_ROWS // TEXT_CHUNK
        for i in range(TRAIN_FILES):
            with open(os.path.join(spool, f"part-{i:04d}.libsvm"), "w") as f:
                f.write("".join(chunks[i * per_file:(i + 1) * per_file]))
        open(os.path.join(spool, "_DONE"), "w").close()
        corpus = os.path.join(tmp, "fleet.libsvm")
        with open(corpus, "w") as f:
            f.write("".join(chunks[:FLEET_ROWS // TEXT_CHUNK]))
        del chunks
        print(f"wrote the spool and the fleet corpus in "
              f"{time.perf_counter() - start:.2f} s [{card}]", flush=True)
        flat = _daemon_in_process(card, ref, spool,
                                  os.path.join(tmp, "ckpt_c"))
        _daemon_cli(card, spool, os.path.join(tmp, "ckpt_d"),
                    os.path.join(tmp, "state_d.json"), flat)
        _fleet(card, corpus, os.path.join(tmp, "ckpt_e"))
    print(f"phase 8: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
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
    phase_serve(card, ref)
    phase_train(card, ref)
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
