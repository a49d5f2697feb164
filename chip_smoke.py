#!/usr/bin/env python3
"""Drive the PyTorch port's hist-GBDT path on one CUDA card and check it.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles ``dmlc_core_tpu_torch/csrc/hist.cu`` with nvcc and
   prints the build seconds and the ptxas report;
3. kernels: at 2,000,000 rows x 28 features x 256 bins and 1, 32 and 256
   nodes, each histogram kernel against its plain PyTorch version on the
   card (rtol 1e-4, atol 1e-3: f32 sums in another order), bitwise
   repeatability of two launches, and CUDA-event times beside the bound and
   one ``index_add_`` over precomputed flat ids (the scatter formulation);
   at 32 nodes also both kernels on the column window 14..27 read in place
   (row stride 28, offset 14) against the plain version on a copy, bitwise
   over two launches; K1 (``hist_matmul_cuda``) alone on ragged shapes
   (1,000,003 rows, 48 weight rows, 255 bins with bins out of range, uint8
   on all columns and int32 on the window 14..27), and K3
   (``grad_hist_fused_cuda``) alone on ragged shapes (1,000,003 rows; 1, 5,
   13, 37 and 256 nodes with node ids in [-2, n + 3); 255 bins with bins
   out of range in int32; windows 14..27 and 2..4; tensors at an offset in
   their allocations), each against its plain version, bitwise over two
   launches and with its launches counted; the K1 and K3 lines also give
   the dense tensor-core time 2*M*B*F*nbins at 989 TFLOP/s beside the
   bound (for K3, M = 16 A rows per 8-node m-tile it computes);
4. GBDT: ``fit_binned`` (10 rounds, depth 6, 256 bins, learning rate 0.3)
   on 2,000,000 HIGGS-shaped rows binned to the uint8 wire, through the
   K1 path (``hist_method="auto"``) and the K3 path (``"pallas_fused"``),
   with launch counts read around that run; ``predict`` on 200,000
   held-out rows; then a 200,000-row fit on the card against the same fit
   on the CPU with the plain versions;
5. distributed GBDT: four worker processes of this script share the card
   as a 2 x 2 data x model mesh over gloo (NCCL refuses two ranks on one
   card).  Each takes the 1,000,000 rows of its data coordinate of the
   phase-4 shape, makes the bin edges with the distributed quantile sketch,
   bins them to uint8 and fits ``GBDT(model_axis="model")`` with
   ``"pallas"`` and ``"pallas_fused"``, so every level runs K4 (the
   windowed kernel on the rank's 14 columns, the data all-reduce, the model
   all-gather).  All ranks must hold the same edges and ensembles, K4 must
   launch on every level, the global accuracy must reach 0.8, and a
   single-process card fit with the same edges must grow the same first
   tree.  Inside the workers K4 at 32 nodes is held against the plain
   histogram of the whole global array and timed beside its bound and the
   collectives.  Then one worker with world size 1 over NCCL fits 200,000
   rows with ``model_axis`` and must match the plain card fit bitwise.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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
    print("probe: both kernels agree with their plain versions", flush=True)


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
        # K2 and K3 compute one function: bins, node/g/h in, (G, H) out
        nbytes = B * F + 12 * B + 2 * n * F * nb * 4
        bound, by = _bound_ms(nbytes, 2 * live * F)
        cases = [("grad_hist_cuda", lambda: hist_cuda.grad_hist_cuda(*args),
                  lambda: hist_cuda.grad_hist_ref(*args)),
                 ("grad_hist_fused_cuda",
                  lambda: hist_cuda.grad_hist_fused_cuda(*args),
                  lambda: hist_cuda.grad_hist_fused_ref(*args))]
        for name, fn, ref in cases:
            got = fn()
            _check_close(name, got, want)
            err = _max_err(got, want)
            same = _bitwise(fn)
            if not same:
                fail(f"{name} is not bitwise repeatable at n={n}")
            ms = cuda_event_ms(fn, iters=5, warmup=1)
            plain_ms = cuda_event_ms(ref, iters=3, warmup=1)
            dense = ""
            if name == "grad_hist_fused_cuda":
                plan = hist_cuda.grad_hist_fused_plan(n, B, F, nb, 1)
                m_rows = 16 * plan.m_tiles * plan.m_blocks
                dense = (f" dense_tc_ms={_dense_tc_ms(m_rows, B, F, nb):.4f}"
                         f" (M={m_rows})")
            print(f"{name:22s} n={n:3d} max_abs_err={err:.3g} (rtol {RTOL}, "
                  f"atol {ATOL}) bitwise={same} ms={ms:.3f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by})"
                  f"{dense} library_ms={library_ms:.3f}", flush=True)
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
        # K1 alone on the weight matrix grad_hist_cuda builds (one sweep)
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
    # the line reports the depth-6 main path's deepest level (32 nodes)
    return [entries[("K1", 32)], entries[("K3", 32)]]


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
          f"(each fit needs >= {need})")
    if launches["hist_matmul_cuda"] < 2 * need:
        fail(f"K1 launched {launches['hist_matmul_cuda']} times, "
             f"expected >= {2 * need}")
    if launches["grad_hist_fused_cuda"] < need:
        fail(f"K3 launched {launches['grad_hist_fused_cuda']} times, "
             f"expected >= {need}")
    for (ens, margin, sec), label in zip(
            fits, ("auto/K1 cold", "auto/K1 warm", "pallas_fused/K3")):
        if margin.shape != (N_ROWS,) or not torch.isfinite(margin).all():
            fail(f"{label}: bad training margin")
        acc = ((margin > 0).float() == y_tr).float().mean().item()
        print(f"fit {label}: {sec:.3f} s, {N_ROWS / sec:,.0f} rows/s, "
              f"train acc {acc:.4f} [{card}]", flush=True)
        if acc < 0.8:
            fail(f"{label}: train accuracy {acc:.4f} < 0.8")
    repeat = all(torch.equal(a, b)
                 for a, b in zip(fits[0][0], fits[1][0]))
    print(f"two fits bitwise identical: {repeat}; K1 vs K3 split agreement "
          f"{_split_agreement(fits[1][0], fits[2][0]):.4f}")
    if prob.shape != (N_HELDOUT,) or not torch.isfinite(prob).all():
        fail("bad held-out predictions")
    held_acc = ((prob > 0.5).float() == y_te).float().mean().item()
    print(f"held-out accuracy {held_acc:.4f} on {N_HELDOUT} rows")
    if held_acc < 0.8:
        fail(f"held-out accuracy {held_acc:.4f} < 0.8")

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
    return launches


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
    out = {}
    for fused in (False, True):
        def k4():
            return hist_cuda.grad_hist_sharded_cuda(*local, n, nb, mesh,
                                                    "model", fused=fused)
        got = k4()
        for a, b in zip(got, want):
            if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
                fail(f"K4 (fused={fused}) disagrees with the plain global "
                     f"histogram: max abs err {_max_err(got, want):.3g}")
        again = k4()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K4 (fused={fused}) is not bitwise repeatable")
        out[f"max_abs_err_fused{int(fused)}"] = _max_err(got, want)
        out[f"k4_ms_fused{int(fused)}"] = cuda_event_ms(k4, iters=5,
                                                        warmup=1)
    del want
    f_count = F // mesh.shape["model"]
    f0 = mesh.coord("model") * f_count
    lb, ln, lg, lh = local
    piece = torch.stack(hist_cuda.grad_hist_cuda(lb, ln, lg, lh, n, nb, f0,
                                                 f_count))
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
        res["ms"] = cuda_event_ms(lambda: hist_cuda.grad_hist_cuda(
            lb, ln, lg, lh, n, nb, f0, f_count), iters=5, warmup=1)
        res["ms_fused"] = cuda_event_ms(lambda: hist_cuda.grad_hist_fused_cuda(
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
    kernels = phase_kernels()
    launches = phase_gbdt(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    k4 = phase_distributed(card)
    kernels.append(dict(
        name="grad_hist_sharded_cuda", route="cuda",
        source="dmlc_core_tpu_torch/csrc/hist.cu",
        replaces="dmlc_core_tpu/ops/hist_pallas.py:350",
        launches=k4["launches"], max_abs_err=k4["max_abs_err_fused0"],
        ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=k4["library_ms"]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
