"""``python -m dmlc_core_tpu_torch.serve`` — run the port's scoring service.

Counterpart of ``python -m dmlc_core_tpu.serve``, single process, with the
same flags plus ``--device`` (``cuda`` unless ``--device cpu``).  For
example, a GBDT checkpoint written by ``GBDT.serving_state`` (either
package's) on port 8080, watching its directory for new steps::

    python -m dmlc_core_tpu_torch.serve --model gbdt --num-feature 28 \
        --checkpoint ckpt/ckpt-00000001 --watch-dir ckpt --port 8080

The process serves until SIGINT/SIGTERM; ``/healthz``, ``/metrics`` and
``/stats`` are live once the ``serving <name> on <url>`` line prints.
``--replicas > 1`` (the router and replica fleet) and ``--transport
evloop`` are not ported yet and exit with an error naming ROADMAP.md §1
item 4; ``--model linear|mlp`` waits for item 9.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.serve.model_runtime import build_runtime
from dmlc_core_tpu_torch.serve.registry import ModelRegistry
from dmlc_core_tpu_torch.serve.server import ScoringServer


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.serve",
        description="low-latency scoring service (micro-batching + "
                    "admission control) on the PyTorch port")
    p.add_argument("--model", default="gbdt",
                   choices=["linear", "mlp", "gbdt"],
                   help="model family (seeded synthetic params unless "
                        "--checkpoint)")
    p.add_argument("--num-feature", type=int, default=28)
    p.add_argument("--checkpoint", default=None,
                   help="bridge/checkpoint.py URI of a serving_state "
                        "checkpoint (gbdt)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=64,
                   help="rows per predict call (throughput knob)")
    p.add_argument("--max-delay-ms", type=float, default=2.0,
                   help="batch assembly wait (latency knob)")
    p.add_argument("--max-queue-bytes", type=int, default=None,
                   help="admission bound (default: DMLC_SERVE_QUEUE_BYTES "
                        "or 64 MiB)")
    p.add_argument("--request-timeout-s", type=float, default=10.0)
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; pass "
                        "'cpu' on a machine without a card)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip warmup (the first requests of each batch "
                        "shape pay the first call's set-up)")
    p.add_argument("--model-name", default=None,
                   help="slot name for routing/metrics (default: the "
                        "model family)")
    p.add_argument("--watch-dir", default=None,
                   help="CheckpointManager directory URI to watch: new "
                        "steps are validated off-path and hot-swapped in "
                        "with zero downtime")
    p.add_argument("--watch-interval-s", type=float, default=None,
                   help="watcher poll interval (default: "
                        "DMLC_SERVE_WATCH_S or 2.0)")
    p.add_argument("--replicas", type=int, default=1,
                   help="replica processes behind a router (not ported "
                        "yet: only 1)")
    p.add_argument("--no-hedge", action="store_true",
                   help="disable request hedging in the router "
                        "(--replicas > 1 only)")
    p.add_argument("--transport", default=None,
                   choices=["threaded", "evloop"],
                   help="HTTP transport: 'threaded' (thread per "
                        "connection; 'evloop' is not ported yet; default: "
                        "DMLC_SERVE_TRANSPORT or threaded)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.replicas < 1:
        parser.error(f"--replicas must be >= 1, got {args.replicas}")
    if args.replicas > 1:
        parser.error("--replicas > 1 needs the port of serve/router.py and "
                     "serve/fleet.py (ROADMAP.md §1 item 4b)")
    # a server without metrics cannot state its SLOs: collection on
    # unconditionally (flushing still needs DMLC_TELEMETRY_DIR)
    telemetry.enable()
    runtime = build_runtime(args.model, args.num_feature, seed=args.seed,
                            checkpoint=args.checkpoint, device=args.device)
    name = args.model_name or runtime.name
    registry = ModelRegistry()
    registry.add(name, runtime, max_batch=args.max_batch,
                 max_delay_ms=args.max_delay_ms,
                 max_queue_bytes=args.max_queue_bytes, default=True)
    server = ScoringServer(
        registry, host=args.host, port=args.port,
        request_timeout_s=args.request_timeout_s,
        warmup=not args.no_warmup, transport=args.transport)
    watcher = None
    if args.watch_dir:
        from dmlc_core_tpu_torch.serve.lifecycle import (CheckpointWatcher,
                                                         runtime_builder)

        watcher = CheckpointWatcher(
            registry, name, args.watch_dir,
            runtime_builder(args.model, args.num_feature, seed=args.seed,
                            device=args.device),
            poll_s=args.watch_interval_s)
    stop = threading.Event()

    def _signal(signum, frame):  # noqa: ARG001 (signal contract)
        stop.set()

    signal.signal(signal.SIGINT, _signal)
    signal.signal(signal.SIGTERM, _signal)
    server.start()
    if watcher is not None:
        watcher.start()
    try:
        # keep "serving <name> on <url>" as the stable prefix: headless
        # launchers scrape this line for the bound URL
        print(f"serving {name} on {server.url} "
              f"(model={runtime.name}, ctrl-c to stop)", flush=True)
        stop.wait()
    finally:
        if watcher is not None:
            watcher.close()
        # graceful drain: /healthz flips to "draining", in-flight requests
        # finish, THEN the listener closes
        server.drain()
    print("serve: shut down cleanly", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
