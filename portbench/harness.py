"""One run of one benchmark cell of the PyTorch/CUDA port.

Everything is found by name.  ``BENCHMARK.json`` at the checkout's root
names the cell's configuration, traffic and chips and lists the metrics;
``portbench/workloads/<cell>.json`` holds the cell's traffic parameters and
its limits; the configuration's ``file`` its sizes and hyperparameters;
``portbench/kinds/<kind>.py`` runs a cell of its ``kind`` (set-up, window,
comparison); ``portbench/metrics/<metric>.py`` reads one per-layer metric
from a traced run (``read(ctx)``, None where it finds nothing to read).
A later cell, configuration or metric is new files and entries.

The run checks for the cards first, fixes the build caches inside the
checkout, runs the kind, judges what the window produced against the
reference, refuses to report if JAX or the JAX package was loaded, and
prints each compared number beside its limit on standard error, then the
result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "dmlc_core_tpu")


class Cell:
    """A cell's entry, traffic file, configuration and metrics."""

    def __init__(self, name: str):
        with open(BENCHMARK) as f:
            bench = json.load(f)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[name]
        with open(os.path.join(HERE, "workloads", name + ".json")) as f:
            self.spec = json.load(f)
        for key in ("config", "traffic", "chips"):
            if self.spec.get(key) != entry[key]:
                raise SystemExit(
                    f"workloads/{name}.json says {key}={self.spec.get(key)!r}"
                    f", BENCHMARK.json {entry[key]!r}")
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        with open(os.path.join(ROOT, conf["file"])) as f:
            self.config = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]
        self.chips = int(entry["chips"])

    def params(self) -> Dict:
        """The port's ``GBDTParam`` fields of this cell: the
        configuration's, then the traffic's overrides."""
        out = dict(self.config["param"])
        out.update(self.spec.get("param", {}))
        return out


def load_metric(name: str):
    """``portbench/metrics/<name>.py`` as a module."""
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str) -> Optional[Dict]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)["devices"].get(kind)


def _fix_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its kernels under ``build/torch_kernels`` itself)."""
    cache = os.path.join(ROOT, "build", "portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def _number(x: float) -> float:
    """JSON has no infinity or NaN: a number that is neither, or 1e300."""
    return float(x) if math.isfinite(x) else 1e300


def _loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float, device: Optional[str] = None) -> int:
    """Run a cell once; ``device=None`` asks for the cards the cell needs
    and fails without them (tests pass ``"cpu"`` to skip that look)."""
    args = parse(argv)
    cell = Cell(args.workload)
    _fix_caches()
    import torch

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s); torch.cuda.is_available()="
                  f"{torch.cuda.is_available()}, device_count="
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    kind = importlib.import_module("portbench.kinds." + cell.spec["kind"])
    run = kind.run(cell, args.seed, args.seconds, bool(args.trace), device,
                   t0)
    bad = _loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    limits = cell.spec["limits"]
    checks = {k: {"value": _number(v), "limit": limits[k]}
              for k, v in run["checks"].items()}
    correct = all(math.isfinite(run["checks"][k])
                  and run["checks"][k] <= limits[k] for k in checks)
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(run["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"]}
    if args.trace:
        ctx = dict(run["trace"], peak=peaks(dev["kind"]),
                   config=cell.config, spec=cell.spec)
        metrics = {}
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result.update(metrics=metrics, device=dev, breakdown={
            "device_ops": [[k, v] for k, v in ctx["top_ops"][:10]],
            "idle_gaps": [[k, v] for k, v in ctx["idle_gaps"][:10]]})
    else:
        # a metric named <quantity>.<suffix> reports <quantity> in its own
        # cells, under a bound of its own
        measured = dict(run["end_to_end"], setup_s=run["setup_s"])
        values = {}
        for m in cell.end_to_end:
            name = m["name"]
            values[name] = measured.get(name,
                                        measured.get(name.split(".")[0]))
        missing = [k for k, v in values.items() if v is None]
        if missing:
            print(f"portbench: {args.workload} measured no "
                  f"{', '.join(missing)}", file=sys.stderr)
            return 4
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end}, device=dev)
    result["checks"] = checks
    print("seconds " + " ".join(f"{k} {v!r}" for k, v in
                                run["seconds"].items()), file=sys.stderr)
    print(f"correct {str(correct).lower()}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
