#!/usr/bin/env python3
"""Time chip_smoke.py's phase-6 libsvm parse with the port found at ROOT,
so that two checkouts can be compared on one machine.

    python3 dmlc_core_tpu_torch/tools/parse_times.py [--root ROOT]
        [--tag T] [--rows 500000] [--repeat 3] [--engine native|numpy]

ROOT (the checkout this file lies in by default) must hold
``dmlc_core_tpu_torch`` and ``chip_smoke.py``.  The file is phase 6's:
``--rows`` HIGGS-shaped rows (28 features) written as libsvm with
``%.9g``; each repeat parses all of it with ``create_parser`` (threaded,
the default thread count) and prints the seconds and rows/s (host clock;
the parse runs on the host only), the engine that ran (from
``native_bridge.ENGINE_CALLS``; ``--engine numpy`` sets
``DMLC_TPU_DISABLE_NATIVE``), then the card's name and power limit.
Compare two checkouts in turns (A, B, B, A), in one run; a checkout
older than the native engine parses with numpy whatever ``--engine``
says, and the line says so.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--engine", choices=("native", "numpy"),
                    default="native")
    args = ap.parse_args()
    if args.engine == "numpy":
        os.environ["DMLC_TPU_DISABLE_NATIVE"] = "1"
    else:
        os.environ.pop("DMLC_TPU_DISABLE_NATIVE", None)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    from chip_smoke import _write_text, make_higgs_like
    from dmlc_core_tpu_torch.data import factory
    from dmlc_core_tpu_torch.data.factory import create_parser

    if not factory.__file__.startswith(root):
        raise SystemExit(f"imported {factory.__file__}, not from {root}")
    try:
        from dmlc_core_tpu_torch import native_bridge
    except ImportError:             # a checkout older than the native engine
        native_bridge = None
    else:
        native_bridge.reset_engine_calls()
    tag = args.tag or root
    x, y = make_higgs_like(args.rows, 28)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.libsvm")
        _write_text(path, x, y, " ", " ", "{}:%.9g")
        secs = []
        for _ in range(args.repeat):
            start = time.perf_counter()
            parser = create_parser(path)
            try:
                rows = sum(block.size for block in parser)
            finally:
                parser.close()
            secs.append(time.perf_counter() - start)
            if rows != args.rows:
                raise SystemExit(f"parsed {rows} rows, wrote {args.rows}")
    if native_bridge is None:
        engine = "numpy (no native engine in this checkout)"
    else:
        calls = native_bridge.ENGINE_CALLS["parse_libsvm"]
        engine = f"native ({calls} native parse calls)" if calls else "numpy"
    print(f"[{tag}] engine: {engine}")
    print(f"[{tag}] parse libsvm {args.rows} rows s="
          + " ".join(f"{s:.3f}" for s in secs) + " rows/s="
          + " ".join(f"{args.rows / s:.0f}" for s in secs), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[{tag}] {card}")


if __name__ == "__main__":
    main()
