"""``python -m dmlc_core_tpu_torch.serve`` — run the port's scoring service.

Counterpart of ``python -m dmlc_core_tpu.serve``, with the same flags
plus ``--device`` (``cuda`` unless ``--device cpu``; every replica of
``--replicas N`` runs there too).  For example, a GBDT checkpoint written
by ``GBDT.serving_state`` (either package's) on port 8080, watching its
directory for new steps::

    python -m dmlc_core_tpu_torch.serve --model gbdt --num-feature 28 \
        --checkpoint ckpt/ckpt-00000001 --watch-dir ckpt --port 8080

or three seeded MLP replicas on the event-loop transport behind a router
on port 8080::

    python -m dmlc_core_tpu_torch.serve --model mlp --replicas 3 \
        --transport evloop --port 8080

The process serves until SIGINT/SIGTERM; ``/healthz``, ``/metrics`` and
``/stats`` are live once the ``serving <name> on <url>`` line prints.
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
from dmlc_core_tpu_torch.utils.device import resolve_device


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dmlc_core_tpu_torch.serve",
        description="low-latency scoring service (micro-batching + "
                    "admission control) on the PyTorch port")
    p.add_argument("--model", default="linear",
                   choices=["linear", "mlp", "gbdt"],
                   help="model family (seeded synthetic params unless "
                        "--checkpoint)")
    p.add_argument("--num-feature", type=int, default=28)
    p.add_argument("--checkpoint", default=None,
                   help="bridge/checkpoint.py URI with trained params "
                        "(linear/mlp) or a serving_state (gbdt)")
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
                   help="run N replica processes behind a health-checked "
                        "router with failover + hedging (--port binds the "
                        "ROUTER; replicas take ephemeral ports)")
    p.add_argument("--no-hedge", action="store_true",
                   help="disable request hedging in the router "
                        "(--replicas > 1 only)")
    p.add_argument("--transport", default=None,
                   choices=["threaded", "evloop"],
                   help="HTTP transport: 'threaded' (thread per "
                        "connection) or 'evloop' (selectors event loop, "
                        "10k+ keep-alive connections; default: "
                        "DMLC_SERVE_TRANSPORT or threaded)")
    return p


def _wait_for_signal(stop: threading.Event) -> None:
    """Block until the SIGINT/SIGTERM handler sets ``stop``.  The wait wakes
    every half second: the OS may deliver the signal to another thread,
    and its Python handler then runs only when the main thread next runs
    bytecode, so an untimed ``stop.wait()`` can sleep through it (a
    replica that never drains)."""
    while not stop.wait(0.5):
        pass


def _run_replicated(args: argparse.Namespace) -> int:
    """--replicas N: a ReplicaFleet of scoring processes behind a
    RouterServer; SIGTERM rolls everything down cleanly (router first —
    stop routing, then drain the replicas)."""
    from dmlc_core_tpu_torch.serve.fleet import ReplicaFleet
    from dmlc_core_tpu_torch.serve.router import RouterServer

    telemetry.enable()
    name = args.model_name or args.model
    extra_args: List[str] = []
    if args.transport:
        # env propagates to replica subprocesses automatically; the
        # explicit flag must reach them the same way
        extra_args += ["--transport", args.transport]
    if args.watch_dir:
        extra_args += ["--watch-dir", args.watch_dir]
        if args.watch_interval_s is not None:
            extra_args += ["--watch-interval-s",
                           str(args.watch_interval_s)]
    fleet = ReplicaFleet(
        args.replicas, model=args.model, num_feature=args.num_feature,
        seed=args.seed, host=args.host, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        max_queue_bytes=args.max_queue_bytes,
        request_timeout_s=args.request_timeout_s,
        checkpoint=args.checkpoint, model_name=args.model_name,
        warmup=not args.no_warmup, extra_args=extra_args,
        device=args.device or "cuda")
    stop = threading.Event()

    def _signal(signum, frame):  # noqa: ARG001 (signal contract)
        stop.set()

    signal.signal(signal.SIGINT, _signal)
    signal.signal(signal.SIGTERM, _signal)
    fleet.start()
    try:
        router = RouterServer(
            fleet.urls, host=args.host, port=args.port,
            hedge=False if args.no_hedge else None,
            # the router outlives one replica try-chain: per-try deadline
            # + retries must fit inside its own request deadline
            request_timeout_s=args.request_timeout_s + 5.0)
        router.start()
    except Exception:
        fleet.close()
        raise
    try:
        # same stable prefix as single-process mode: headless launchers
        # scrape "serving <name> on <url>" for the bound URL
        print(f"serving {name} on {router.url} "
              f"(replicas={args.replicas}, ctrl-c to stop)", flush=True)
        _wait_for_signal(stop)
    finally:
        router.close()
        fleet.close()
    print("serve: shut down cleanly", flush=True)
    return 0


def _raise_nofile_limit() -> None:
    """Best-effort soft→hard RLIMIT_NOFILE bump: a 10k-connection event
    loop cannot live inside the usual 1024 soft cap, and raising to the
    hard limit is always allowed."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if hard > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, OSError, ValueError):
        pass


def main(argv: Optional[List[str]] = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    if args.replicas < 1:
        parser.error(f"--replicas must be >= 1, got {args.replicas}")
    # no card and no --device cpu: raise here, naming the device, before
    # any replica is launched
    resolve_device(args.device)
    _raise_nofile_limit()
    if args.replicas > 1:
        return _run_replicated(args)
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
        _wait_for_signal(stop)
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
