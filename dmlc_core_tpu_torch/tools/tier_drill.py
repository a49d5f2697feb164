#!/usr/bin/env python3
"""chip_smoke.py's serving-tier drill (phase 9), under a chosen router
listen backlog and host load.

Run from the root of a checkout on a machine with a CUDA card:

    python3 dmlc_core_tpu_torch/tools/tier_drill.py \
        [--runs 128:0,1024:0,1024:4] [--rate 120]

Fits phase 4's model, then runs phase 9 (``phase_tier``: 3 card replicas
behind a router in a process of its own, open-loop load at ``--rate``
requests/s, then 3x that rate through a SIGKILL and a rolling restart)
once per ``BACKLOG:HOGS`` entry of ``--runs``: the router's listen
backlog (the threaded transport's ``request_queue_size``) and the number
of CPU-burning processes started beside it for the run.  For each load
run it prints the outcome counts and HTTP statuses, the slowest requests,
and how many requests never reached the router (the client's count less
the router's own ``dmlc_router_requests_total``).  A run whose checks
fail is reported and the next one starts.  Ends with the card's name and
power limit.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from dmlc_core_tpu_torch.serve import server as _server  # noqa: E402

# the router runs in a spawned process that imports this module again:
# the backlog reaches it through the environment
if os.environ.get("TIER_DRILL_BACKLOG"):
    _server._Server.request_queue_size = int(
        os.environ["TIER_DRILL_BACKLOG"])


class _Failed(Exception):
    pass


def _fail(msg):
    raise _Failed(msg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default="128:0,1024:0,1024:4")
    ap.add_argument("--rate", type=float, default=120.0)
    args = ap.parse_args()
    import chip_smoke as cs

    runs = [tuple(int(v) for v in r.split(":"))
            for r in args.runs.split(",")]
    seen = {"requests": 0, "label": ""}
    check_load = cs._check_load

    def check(label, report):
        # the router's request counter is cumulative over the drill's
        # load runs; the client's count is summed the same way
        seen["requests"] += report["requests"]
        metrics = (report.get("server") or {}).get("metrics", {})
        routed = sum(v for k, v in metrics.items()
                     if k.startswith("dmlc_router_requests_total"))
        print(f"tier_drill {seen['label']} {label}: counts "
              f"{report['counts']}, statuses {report['statuses']}, "
              f"connections {report['connections']}, never reached the "
              f"router {seen['requests'] - routed:g}, load ran "
              f"{report['wall_s']} s for {report['duration_s']:g}; slowest "
              f"{[(s['outcome'], s['latency_ms']) for s in report['slowest_traces']]}",
              flush=True)
        try:
            check_load(label, report)
        except _Failed as exc:
            print(f"tier_drill {seen['label']} check failed: {exc}",
                  flush=True)

    cs.fail = _fail
    cs._check_load = check
    card = cs.phase_device()
    cs.phase_build()
    _, ref = cs.phase_gbdt(card)
    for backlog, hogs in runs:
        seen.update(requests=0, label=f"backlog {backlog}, {hogs} hogs")
        os.environ["TIER_DRILL_BACKLOG"] = str(backlog)
        burners = [subprocess.Popen([sys.executable, "-c",
                                     "while True: pass"])
                   for _ in range(hogs)]
        t0 = time.perf_counter()
        try:
            cs.phase_tier(card, ref, args.rate)
            verdict = "passed"
        except _Failed as exc:
            verdict = f"failed: {exc}"
        finally:
            for p in burners:
                p.kill()
                p.wait()
        print(f"tier_drill {seen['label']}: phase 9 {verdict} in "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
