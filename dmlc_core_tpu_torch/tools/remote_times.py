#!/usr/bin/env python3
"""Time split reads of one object in a loopback mock bucket, per engine.

    python3 dmlc_core_tpu_torch/tools/remote_times.py [--rows 500000]
        [--repeat 3] [--rings 2,8,16] [--store inprocess|subprocess]
        [--tag T]

The object is chip_smoke.py's phase-6 file: ``--rows`` HIGGS-shaped rows
(28 features) as libsvm with ``%.9g``, uploaded to the strict SigV4 mock
store chip_smoke.py's phase 13 uses, on 127.0.0.1.  Each repeat reads the
whole object through ``create_input_split(..., "text")``, without parsing:
once with the Python split engine (the default for remote URIs) and once
per ``--rings`` depth with the native engine (``DMLC_TPU_NATIVE_REMOTE=1``,
``DMLC_NATIVE_RING``; byte reads through the read-at callback, chunks taken
as zero-copy views, a batched pop above ring 2).  Engines take turns within
a repeat.  Each line gives the seconds, MB/s (host clock) and the GET round
trips (the ``dmlc_filesystem_request_seconds`` series), then the card's
name and power limit.

``--store inprocess`` runs the store's handler threads in this process, as
phase 13 does (they contend for the GIL with the callback);
``--store subprocess`` runs it in a process of its own.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time


SECRET = "remote-times-secret"


def _store_process(root):
    """The mock store in a child process; (process, port)."""
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; s = chip_smoke._mock_s3_class()("
            "secrets=[sys.argv[2]]).start(); "
            "print(s.port, flush=True); time.sleep(10 ** 6)")
    proc = subprocess.Popen([sys.executable, "-c", code, root, SECRET],
                            stdout=subprocess.PIPE, text=True)
    return proc, int(proc.stdout.readline())


def _read(uri, native):
    from dmlc_core_tpu_torch.io.input_split import create_input_split

    split = create_input_split(uri, 0, 1, "text")
    take = split.next_chunk_view if native else split.next_chunk
    nbytes = 0
    try:
        while True:
            chunk = take()
            if chunk is None:
                return nbytes
            nbytes += chunk[1] if native else len(chunk)
    finally:
        split.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(os.path.dirname(here))
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--rings", default="2,8,16")
    ap.add_argument("--store", choices=("inprocess", "subprocess"),
                    default="inprocess")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, root)

    from chip_smoke import _mock_s3_class, _write_text, make_higgs_like
    from dmlc_core_tpu_torch import native_bridge, telemetry
    from dmlc_core_tpu_torch.io.stream import create_stream

    tag = args.tag or f"store {args.store}"
    if args.store == "inprocess":
        store = _mock_s3_class()().start()
        port, proc = store.port, None
    else:
        proc, port = _store_process(root)
        store = None
    os.environ.update(AWS_ACCESS_KEY_ID="remote-times",
                      AWS_SECRET_ACCESS_KEY=SECRET,
                      AWS_REGION="us-east-1",
                      S3_ENDPOINT=f"http://127.0.0.1:{port}")
    for key in ("DMLC_TPU_DISABLE_NATIVE", "DMLC_TPU_NATIVE_REMOTE",
                "DMLC_NATIVE_RING"):
        os.environ.pop(key, None)
    uri = "s3://bucket/train.libsvm"
    try:
        x, y = make_higgs_like(args.rows, 28)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "train.libsvm")
            size = _write_text(path, x, y, " ", " ", "{}:%.9g")
            with open(path, "rb") as fi, create_stream(uri, "w") as fo:
                for piece in iter(lambda: fi.read(8 << 20), b""):
                    fo.write(piece)
        del x, y
        native_bridge.load_library()
        telemetry.enable()
        engines = [("python", None)] + [
            ("native", int(r)) for r in args.rings.split(",")]
        times = {e: [] for e in engines}
        gets = {}
        for _ in range(args.repeat):
            for engine, ring in engines:
                if engine == "native":
                    os.environ["DMLC_TPU_NATIVE_REMOTE"] = "1"
                    os.environ["DMLC_NATIVE_RING"] = str(ring)
                else:
                    os.environ.pop("DMLC_TPU_NATIVE_REMOTE", None)
                    os.environ.pop("DMLC_NATIVE_RING", None)
                telemetry.reset()
                native_bridge.reset_engine_calls()
                start = time.perf_counter()
                nbytes = _read(uri, engine == "native")
                times[(engine, ring)].append(time.perf_counter() - start)
                if nbytes != size:
                    raise SystemExit(f"read {nbytes} bytes of {size}")
                chunks = native_bridge.ENGINE_CALLS["lsplit_next_chunk"]
                if (chunks > 0) != (engine == "native"):
                    raise SystemExit(f"{engine}: {chunks} native chunks")
                samples = telemetry.snapshot()["metrics"][
                    "dmlc_filesystem_request_seconds"]["samples"]
                gets[(engine, ring)] = sum(
                    s["count"] for s in samples
                    if s["labels"] == {"fs": "s3", "op": "GET"})
        for (engine, ring), secs in times.items():
            name = engine if ring is None else f"native ring {ring}"
            print(f"[{tag}] {name}: {size} bytes s="
                  + " ".join(f"{s:.3f}" for s in secs) + " MB/s="
                  + " ".join(f"{size / s / 1e6:.1f}" for s in secs)
                  + f" GETs={gets[(engine, ring)]}", flush=True)
    finally:
        if store is not None:
            store.stop()
        if proc is not None:
            proc.kill()
            proc.wait()
    card = ["no nvidia-smi on this machine"]
    if shutil.which("nvidia-smi"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()
    print(f"[{tag}] {card[0]}")


if __name__ == "__main__":
    main()
