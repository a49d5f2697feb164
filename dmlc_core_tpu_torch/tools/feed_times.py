#!/usr/bin/env python3
"""Time the device feed on the card: ``DeviceFeedLoader``'s pinned ring
against synchronous copies, at ``chip_smoke.py`` phase 6's shape.

Run from the root of a checkout on a machine with a CUDA card:

    python3 dmlc_core_tpu_torch/tools/feed_times.py [--rows 500000]
        [--batch 8192] [--repeat 5]

The batches are binned ones (uint8 bins [batch, 28], float32 labels and
weights, the last one padded), made in memory, so only the feed is timed.
Every variant ends in the consumer's copy of each batch's real rows into
one preallocated tensor on the card (what ``train_gbdt`` and phase 6 do),
so all of them do the same work on the card:

- ``sync``: ``.to(card)`` of each pageable tensor, one after the other;
- ``sync_pinned``: ``.to(card, non_blocking=True)`` of tensors pinned
  beforehand (the host-to-card copy without the staging, a floor);
- ``loader pN``: ``DeviceFeedLoader(prefetch=N)``, telemetry off;
- ``loader p2 telemetry``: the same with telemetry on, which times each
  hand-off's ``event.synchronize()`` (the non-overlapped wait);
- ``loader p2 iterate``: the loader with no consumer copy.

Each line gives the best of ``--repeat`` epochs (host clock ending in
``torch.cuda.synchronize()``), GB/s of batch bytes and microseconds per
batch, beside the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from dmlc_core_tpu_torch import telemetry  # noqa: E402
from dmlc_core_tpu_torch.bridge.binning import BinnedBatch  # noqa: E402
from dmlc_core_tpu_torch.bridge.loader import (DeviceFeedLoader,  # noqa: E402
                                               batch_nbytes)

N_FEATURES = 28


def _batches(rows, batch, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for lo in range(0, rows, batch):
        real = min(batch, rows - lo)
        weight = np.zeros(batch, np.float32)
        weight[:real] = 1.0
        out.append(BinnedBatch(
            torch.from_numpy(rng.randint(0, 256, (batch, N_FEATURES))
                             .astype(np.uint8)),
            torch.from_numpy((rng.rand(batch) > 0.5).astype(np.float32)),
            torch.from_numpy(weight), num_rows=real))
    return out


def _consume(stream, rows, dev):
    bins = torch.empty((rows, N_FEATURES), dtype=torch.uint8, device=dev)
    label = torch.empty(rows, dtype=torch.float32, device=dev)
    row = 0
    for b in stream:
        k = b.num_rows
        bins[row:row + k] = b.bins[:k]
        label[row:row + k] = b.label[:k]
        row += k
    return bins, label


def _best(fn, repeat):
    best = float("inf")
    out = None
    for _ in range(repeat):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - start)
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("feed_times: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    batches = _batches(args.rows, args.batch)
    pinned = [BinnedBatch(*(t.pin_memory() for t in b[:3]),
                          num_rows=b.num_rows) for b in batches]
    nbytes = sum(batch_nbytes(b) for b in batches)
    want = _consume(iter(batches), args.rows, "cpu")

    def sync():
        return _consume((BinnedBatch(*(t.to(dev) for t in b[:3]),
                                     num_rows=b.num_rows) for b in batches),
                        args.rows, dev)

    def sync_pinned():
        return _consume((BinnedBatch(*(t.to(dev, non_blocking=True)
                                       for t in b[:3]), num_rows=b.num_rows)
                         for b in pinned), args.rows, dev)

    def loader(prefetch, consume=True):
        feed = DeviceFeedLoader(lambda: iter(batches), prefetch=prefetch)

        def run():
            if consume:
                return _consume(iter(feed), args.rows, dev)
            for _ in feed:
                pass
            return None
        return run

    variants = [("sync", sync), ("sync_pinned", sync_pinned)]
    variants += [(f"loader p{p}", loader(p)) for p in (1, 2, 4)]
    variants += [("loader p2 iterate", loader(2, consume=False))]
    print(f"feed_times: {args.rows:,} rows in {len(batches)} batches of "
          f"{args.batch}, {nbytes:,} batch bytes [{card}]", flush=True)
    for name, fn in variants:
        sec, out = _best(fn, args.repeat)
        if out is not None and not all(torch.equal(a.cpu(), b)
                                       for a, b in zip(out, want)):
            sys.exit(f"feed_times: {name} delivered other bytes")
        print(f"{name:22s} {sec * 1e3:8.3f} ms  {nbytes / sec / 1e9:6.3f} "
              f"GB/s  {sec / len(batches) * 1e6:7.1f} us/batch [{card}]",
              flush=True)
    telemetry.enable()
    telemetry.reset()
    sec, _ = _best(loader(2), args.repeat)
    reg = telemetry.get_registry()
    wait = reg.counter("dmlc_transfer_seconds_total", path="device_feed",
                       phase="wait").value / args.repeat
    dispatch = reg.counter("dmlc_transfer_seconds_total", path="device_feed",
                           phase="dispatch").value / args.repeat
    telemetry.disable()
    print(f"{'loader p2 telemetry':22s} {sec * 1e3:8.3f} ms  "
          f"{nbytes / sec / 1e9:6.3f} GB/s  dispatch {dispatch * 1e3:.3f} ms, "
          f"non-overlapped wait {wait * 1e3:.3f} ms an epoch [{card}]",
          flush=True)


if __name__ == "__main__":
    main()
