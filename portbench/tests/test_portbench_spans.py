"""The reduction of a traced call by the port's program spans
(``portbench/spans.py``): on hand-built Chrome traces, and through the
command on the CPU in a throwaway checkout, where the port's own spans
reach the profiler's trace."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spans, trace
from portbench.tests import tiny

READINGS = ("split_scan_ms", "route_ms", "leaf_ms", "draw_ms",
            "hist_self_ms", "host_syncs_per_round", "outside_pct")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 2, correlation=corr)


def _kernel(ts, dur, corr, name="k"):
    return _x("kernel", name, ts, dur, tid=0, correlation=corr)


def _round_trace(with_spans=True):
    """One round on the main thread (tid 1): a histogram, a split scan with
    a level draw in it, routing, leaf sums; kernels launched in each and one
    outside, a memset whose launch is missing, two syncs; and a span of
    another thread that covers everything."""
    ann = [_x("user_annotation", "portbench.window", 0, 1000)]
    if with_spans:
        ann += [_x("user_annotation", n, a, b - a) for n, a, b in (
            ("gbdt.round", 10, 500), ("gbdt.hist", 20, 100),
            ("gbdt.split_scan", 100, 200), ("gbdt.draw", 150, 180),
            ("gbdt.route", 200, 300), ("gbdt.leaf", 300, 400))]
        ann.append(_x("user_annotation", "gbdt.route", 0, 1000, tid=2))
    host = [_launch(30, 1), _launch(160, 2), _launch(120, 3),
            _launch(250, 4), _launch(350, 5), _launch(600, 6),
            _x("cpu_op", "aten::cumsum", 85, 10),
            _x("cuda_runtime", "cudaStreamSynchronize", 170, 5),
            _x("cuda_runtime", "cudaDeviceSynchronize", 700, 5)]
    dev = [_kernel(40, 50, 1, "k3"), _kernel(200, 10, 2),
           _kernel(130, 20, 3), _kernel(260, 30, 4), _kernel(360, 40, 5),
           _kernel(610, 100, 6), _x("gpu_memset", "set", 800, 20, tid=0,
                                    correlation=99)]
    return ann + host + dev


def _ctx(events, **kind):
    """A kind's traced context: the harness's reduction and the spans'."""
    return dict(trace.reduce_trace(events), **spans.reduce_spans(events),
                **kind)


def test_device_time_goes_to_the_innermost_span_by_launch():
    red = spans.reduce_spans(_round_trace())
    assert red["span_device_ms"] == pytest.approx({
        "gbdt.hist": 0.050, "gbdt.draw": 0.010, "gbdt.split_scan": 0.020,
        "gbdt.route": 0.030, "gbdt.leaf": 0.040, "(outside)": 0.120})
    # another thread's span is no program span of the main thread
    assert red["span_calls"] == {"gbdt.round": 1, "gbdt.hist": 1,
                                 "gbdt.split_scan": 1, "gbdt.draw": 1,
                                 "gbdt.route": 1, "gbdt.leaf": 1}
    # every op lies in some span or outside: the totals are the ops'
    plain = trace.reduce_trace(_round_trace())
    assert sum(red["span_device_ms"].values()) == pytest.approx(
        1e3 * sum(s for _, s in plain["top_ops"]))


def test_idle_gaps_are_labelled_by_span_and_host_op():
    red = spans.reduce_spans(_round_trace())
    idle = dict(red["span_idle_gaps"])
    # gaps begin at 0, 710 and 820 with no span open, at 90 in the
    # histogram's span inside a cumsum, at 150 in the draw, at 210 and 290
    # in routing, at 400 in the round after its leaf sums
    assert idle["python"] == pytest.approx((40 + 90 + 180) / 1e6)
    assert idle["gbdt.hist/aten::cumsum"] == pytest.approx(40e-6)
    assert idle["gbdt.draw/python"] == pytest.approx(50e-6)
    assert idle["gbdt.route/python"] == pytest.approx(120e-6)
    assert idle["gbdt.round/python"] == pytest.approx(210e-6)
    assert red["span_idle_ms"] == pytest.approx({
        "(outside)": 0.31, "gbdt.hist": 0.04, "gbdt.draw": 0.05,
        "gbdt.route": 0.12, "gbdt.round": 0.21})
    # the same gaps as the harness's breakdown, relabelled
    plain = dict(trace.reduce_trace(_round_trace())["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(sum(plain.values()))
    without = dict(spans.reduce_spans(_round_trace(False))["span_idle_gaps"])
    assert without == pytest.approx(dict(
        trace.reduce_trace(_round_trace(False))["idle_gaps"]))


def test_syncs_are_counted_by_span_and_round():
    red = spans.reduce_spans(_round_trace())
    assert red["span_syncs"] == {"gbdt.draw": 1, "(outside)": 1,
                                 "(inside gbdt.round)": 1}
    bare = spans.reduce_spans(_round_trace(False))
    assert bare["span_syncs"] == {"(outside)": 2, "(inside gbdt.round)": 0}
    assert bare["span_calls"] == {}


def test_readings_are_per_round():
    got = spans.readings(_ctx(_round_trace(), kind="train", rounds=2))
    assert got == pytest.approx({
        "split_scan_ms": 0.010, "route_ms": 0.015, "leaf_ms": 0.020,
        "draw_ms": 0.005, "hist_self_ms": 0.025,
        "host_syncs_per_round": 0.5,
        # 120 us of 270 us busy launched in no span
        "outside_pct": 100.0 * 120 / 270})


@pytest.mark.parametrize("reading", READINGS)
def test_reading_is_none_without_spans_or_on_scoring(reading):
    assert spans.readings(_ctx(_round_trace(False), kind="train",
                               rounds=2))[reading] is None
    assert spans.readings(_ctx(_round_trace(), kind="score",
                               calls=1))[reading] is None
    # a CPU trace: spans, but no device
    cpu = [e for e in _round_trace() if e["cat"] not in trace.DEVICE_CATS]
    assert spans.readings(_ctx(cpu, kind="train", rounds=2))[reading] \
        is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("spans"))


def _command(root, workload):
    src = "\n".join([
        "import sys", f"sys.path.insert(0, {root!r})",
        "from portbench import spans",
        f"sys.exit(spans.main(['--workload', {workload!r}, '--seed', "
        f"'{2 ** 31 + 7}', '--seconds', '1'], device='cpu'))"])
    proc = subprocess.run([sys.executable, "-c", src], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    *_, result, line = proc.stdout.strip().splitlines()
    return json.loads(result), json.loads(line)


@pytest.mark.parametrize("workload,draws", [
    ("tiny.train", 0),
    # a tree draw and a level draw at each of the tree's levels
    ("tiny.train_sampled", 1 + tiny.TINY["param"]["max_depth"])])
def test_command_sees_the_ports_training_spans(checkout, workload, draws):
    result, line = _command(checkout, workload)
    assert result["correct"] is True
    rounds = tiny.CELLS[workload]["chunk_rounds"]
    depth = tiny.TINY["param"]["max_depth"]
    calls = line["span_calls"]
    assert calls["gbdt.round"] == rounds
    for name in ("gbdt.hist", "gbdt.split_scan", "gbdt.route"):
        assert calls[name] == rounds * depth, name
    assert calls["gbdt.leaf"] == rounds
    assert calls.get("gbdt.draw", 0) == rounds * draws
    # the CPU trace has no device: nothing to read per round
    assert set(line["readings"]) == set(READINGS)
    assert all(v is None for v in line["readings"].values())


def test_command_sees_the_ports_scoring_span(checkout):
    result, line = _command(checkout, "tiny.score")
    assert result["correct"] is True
    assert line["span_calls"] == {"gbdt.predict": 1}
    assert all(v is None for v in line["readings"].values())
