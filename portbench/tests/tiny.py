"""A throwaway checkout of the benchmark for CPU tests.

:func:`checkout` copies ``BENCHMARK.json`` and ``portbench/`` into a
directory, links the port beside them, and adds a tiny configuration and
its cells as new files and entries, exactly as a later change adds
them; :func:`run` runs one cell there in a fresh interpreter on the CPU,
through the harness's own ``main`` after an optional fault is planted.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TINY = {"rows": 3000, "features": 5,
        "param": {"objective": "logistic", "max_depth": 3,
                  "learning_rate": 0.3, "num_bins": 16,
                  # the CPU plain version of the card's histogram kernel
                  "hist_method": "pallas"},
        "hist_dtype": "bfloat16",
        "leaf_sum_dtype": "float32 matmul, TF32 off",
        "margin_dtype": "float32",
        "data": {"latent_factors": 4, "feature_noise": 1.0,
                 "label_linear": 3, "label_pairs": 2, "label_noise": 0.5}}

CELLS = {
    "tiny.train": dict(kind="train", warmup_rounds=2, chunk_rounds=3,
                       check_trees=2, param={}, like="higgs.train"),
    "tiny.train_sampled": dict(kind="train", warmup_rounds=2,
                               chunk_rounds=3, check_trees=2,
                               param={"subsample": 0.8,
                                      "colsample_bytree": 0.8,
                                      "colsample_bylevel": 0.8},
                               like="higgs.train.sampled"),
    "tiny.score": dict(kind="score", trees=60, leaf_scale=0.1,
                       table_rows=4000, batch_rows=1000, check_batches=2,
                       param={}, like="higgs.score"),
}


def checkout(dest) -> str:
    """A checkout under ``dest`` with the tiny cells added; returns it."""
    dest = str(dest)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "dmlc_core_tpu_torch"),
               os.path.join(dest, "dmlc_core_tpu_torch"))
    pb = os.path.join(dest, "portbench")
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(dict(TINY, name="tiny", source="test", reduced=[]), f)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    for name, spec in CELLS.items():
        spec = dict(spec)
        like = spec.pop("like")
        with open(os.path.join(pb, "workloads", like + ".json")) as f:
            real = json.load(f)
        traffic = name.split(".", 1)[1]
        spec.update(config="tiny", traffic=traffic, chips=1, why="a test",
                    limits=real["limits"])
        with open(os.path.join(pb, "workloads", name + ".json"), "w") as f:
            json.dump(spec, f)
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "a test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def run(root: str, workload: str, seed: int = 2 ** 31 + 5,
        seconds: float = 1.0, trace: int = 0, plant: str = "",
        entry: str = "harness"):
    """Run ``workload`` once on the CPU in ``root`` after executing
    ``plant`` (a fault, Python source); returns (rc, stdout, stderr)."""
    if entry == "harness":
        call = (f"harness.main(['--workload', {workload!r}, '--seed', "
                f"'{seed}', '--seconds', '{seconds}', '--trace', "
                f"'{trace}'], t0, device='cpu')")
    else:
        call = (f"control.main(['--workload', {workload!r}, '--seeds', "
                f"'{seed}'], device='cpu')")
    src = "\n".join([
        "import sys, time", "t0 = time.perf_counter()",
        f"sys.path.insert(0, {root!r})",
        "from portbench import harness, control", plant,
        f"sys.exit({call})"])
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", src], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    return proc.returncode, proc.stdout, proc.stderr
