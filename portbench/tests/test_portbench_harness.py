"""The harness finds a new configuration, cell and per-layer metric by name
from new files and entries alone, and prints one result line of the
contract's shape last.  On the CPU, in a throwaway checkout."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests import tiny

ROOT = tiny.ROOT
METRIC = '''"""A throwaway metric: histogram calls a round."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["hist_calls"] / ctx["rounds"]
'''


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tiny.checkout(tmp_path_factory.mktemp("bench"))
    with open(os.path.join(root, "portbench", "metrics",
                           "tiny_hist_calls.py"), "w") as f:
        f.write(METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "tiny_hist_calls", "unit": "calls", "better": "lower",
        "source": "program_span", "layer": "ops/histogram.py grad_histogram",
        "moves": "train_row_rounds_per_s", "workloads": ["tiny.train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _last(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_new_cell_runs(checkout, workload):
    rc, out, err = tiny.run(checkout, workload)
    assert rc == 0, err
    res = _last(out)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, err
    assert res["attempted"] > 0 and res["failed"] == 0
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        names = {m["name"] for m in json.load(f)["end_to_end"]
                 if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == names
    assert all(m["value"] >= 0 for m in res["metrics"].values())
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])


def test_new_metric_is_read_in_a_traced_run(checkout):
    rc, out, err = tiny.run(checkout, "tiny.train", trace=1)
    assert rc == 0, err
    res = _last(out)
    assert res["correct"] is True
    # three levels, one histogram each
    assert res["metrics"]["tiny_hist_calls"]["value"] == 3
    assert "train_row_rounds_per_s" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_no_result(checkout):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tiny.train",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=checkout,
        capture_output=True, text=True, timeout=120)
    try:
        import torch
        has_card = torch.cuda.is_available()
    except ImportError:
        has_card = False
    if has_card:
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_bare_checkout_gives_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(tmp_path, "portbench"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "higgs.train",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", name, "--seed",
             "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert _last(proc.stdout)["correct"] is True, proc.stderr[-2000:]
