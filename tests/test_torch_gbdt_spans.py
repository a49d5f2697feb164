"""The port's boosting round and scoring call record telemetry spans, and
every telemetry span is also a ``torch.profiler`` annotation while the
profiler records (CPU; small fits).

A fit with collection on records one ``gbdt.round`` a round, and in each
tree ``max_depth`` each of ``gbdt.hist``, ``gbdt.split_scan`` and
``gbdt.route``, one ``gbdt.leaf`` and the sampling draws, nested by time;
with collection off and no profiler nothing is recorded and no
``record_function`` is entered; under the profiler the spans show as
``user_annotation`` events whose times match the span file's through the
two clocks' wall anchors.
"""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.models import gbdt

ROWS, F, NB, DEPTH, ROUNDS = 600, 4, 16, 3, 2
SAMPLED = dict(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8)


@pytest.fixture
def collection():
    """Collection on for the test, with the tracer emptied before and
    after and the switch put back as it was."""
    was = telemetry.enabled()
    telemetry.enable()
    telemetry.reset()
    yield telemetry.get_tracer()
    telemetry.reset()
    if not was:
        telemetry.disable()


@pytest.fixture
def collection_off():
    was = telemetry.enabled()
    telemetry.disable()
    telemetry.reset()
    yield telemetry.get_tracer()
    telemetry.reset()
    if was:
        telemetry.enable()


def _data():
    gen = torch.Generator().manual_seed(3)
    bins = torch.randint(0, NB, (ROWS, F), generator=gen, dtype=torch.uint8)
    label = (torch.rand(ROWS, generator=gen) > 0.5).to(torch.float32)
    return bins, label


def _fit(**param):
    bins, label = _data()
    model = gbdt.GBDT(gbdt.GBDTParam(max_depth=DEPTH, num_bins=NB,
                                     num_boost_round=ROUNDS, **param),
                      num_feature=F, device="cpu")
    ens, _ = model.fit_binned(bins, label)
    return model, ens, bins


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _spans(events, name):
    return [e for e in events if e["name"] == name]


@pytest.mark.parametrize("sampled", [False, True])
def test_fit_records_the_round_spans_nested(collection, sampled):
    _fit(**(SAMPLED if sampled else {}))
    events = collection.events()
    counts = collections.Counter(e["name"] for e in events)
    draws = ROUNDS * (1 + DEPTH) if sampled else 0
    assert counts == collections.Counter(
        {"gbdt.round": ROUNDS, "gbdt.hist": ROUNDS * DEPTH,
         "gbdt.split_scan": ROUNDS * DEPTH, "gbdt.route": ROUNDS * DEPTH,
         "gbdt.leaf": ROUNDS, **({"gbdt.draw": draws} if draws else {})})
    rounds = _spans(events, "gbdt.round")
    assert [r["args"] for r in rounds] == [
        {"round": r, "rows": ROWS, "features": F} for r in range(ROUNDS)]
    for name in ("gbdt.hist", "gbdt.split_scan", "gbdt.route", "gbdt.leaf",
                 "gbdt.draw"):
        for e in _spans(events, name):
            assert sum(_within(e, r) for r in rounds) == 1, name
    for r in rounds:
        inside = [e for e in events if e is not r and _within(e, r)]
        levels = [(e["name"], e["args"].get("depth")) for e in inside
                  if e["name"] in ("gbdt.hist", "gbdt.split_scan",
                                   "gbdt.route")]
        # each level: histogram, then split scan, then routing, in order
        assert levels == [(n, d) for d in range(DEPTH)
                          for n in ("gbdt.hist", "gbdt.split_scan",
                                    "gbdt.route")]
        assert [e["args"]["nodes"] for e in inside
                if e["name"] == "gbdt.hist"] == [2 ** d for d in range(DEPTH)]
        # below the root the kernel builds one child of each parent
        assert [e["args"]["built"] for e in inside
                if e["name"] == "gbdt.hist"] == [1] + [
                    2 ** (d - 1) for d in range(1, DEPTH)]
        leaf, = [e for e in inside if e["name"] == "gbdt.leaf"]
        assert leaf["args"]["leaves"] == 2 ** DEPTH
        assert leaf["ts"] >= max(e["ts"] + e["dur"] for e in inside
                                 if e["name"] == "gbdt.route")
        draws_in = [e for e in inside if e["name"] == "gbdt.draw"]
        if not sampled:
            assert draws_in == []
            continue
        tree_draw, = [e for e in draws_in if e["args"]["scope"] == "tree"]
        first_hist = min(e["ts"] for e in inside if e["name"] == "gbdt.hist")
        assert tree_draw["ts"] + tree_draw["dur"] <= first_hist
        level_draws = [e for e in draws_in if e["args"]["scope"] == "level"]
        assert [e["args"]["depth"] for e in level_draws] == list(range(DEPTH))
        scans = _spans(inside, "gbdt.split_scan")
        for d in level_draws:
            assert sum(_within(d, s) for s in scans) == 1


def test_predict_records_one_span_a_call(collection):
    model, ens, bins = _fit()
    telemetry.reset()
    model.predict(ens, bins)
    events = collection.events()
    # on the CPU the plain version scores ("cuda": the traversal kernel)
    assert [(e["name"], e["args"]) for e in events] == [
        ("gbdt.predict", {"trees": ROUNDS, "rows": ROWS, "method": "ref"})]


@pytest.mark.parametrize("method", ["auto", "scatter", "onehot", "pallas",
                                    "pallas_fused"])
def test_hist_span_says_which_rows_it_reads(collection, method):
    """``gbdt.hist``'s ``rows``: ``"all"`` at the root; below it
    ``"listed"`` for the kernel methods, which read the built nodes' rows
    alone, and ``"all"`` for the others (``"auto"`` is ``"scatter"`` on
    the CPU)."""
    _fit(hist_method=method)
    hists = _spans(collection.events(), "gbdt.hist")
    assert len(hists) == ROUNDS * DEPTH
    lists = method in ("pallas", "pallas_fused")
    for e in hists:
        below = e["args"]["depth"] > 0
        assert e["args"]["rows"] == ("listed" if below and lists else "all")


@pytest.mark.parametrize("sampled", [False, True])
def test_span_attributes_are_host_ints_and_strings(collection, sampled):
    model, ens, bins = _fit(**(SAMPLED if sampled else {}))
    model.predict(ens, bins)
    events = collection.events()
    assert events
    for e in events:
        for k, v in e.get("args", {}).items():
            assert type(v) in (int, str), (e["name"], k, type(v))


def test_off_records_nothing_and_enters_no_annotation(collection_off,
                                                      monkeypatch):
    entered = []

    class Recording:
        def __init__(self, name, *a, **k):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Recording)
    assert telemetry.span("gbdt.round", round=0) is telemetry._NULL_SPAN
    model, ens, bins = _fit(**SAMPLED)
    model.predict(ens, bins)
    assert collection_off.events() == []
    assert entered == []


def _profiled_fit(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model, ens, bins = _fit(**SAMPLED)
        model.predict(ens, bins)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def test_spans_are_profiler_annotations_with_collection_off(collection_off,
                                                            tmp_path):
    trace = _profiled_fit(tmp_path)
    marks = collections.Counter(
        e["name"] for e in trace["traceEvents"]
        if e.get("cat") == "user_annotation"
        and e.get("name", "").startswith("gbdt."))
    assert marks == collections.Counter(
        {"gbdt.round": ROUNDS, "gbdt.hist": ROUNDS * DEPTH,
         "gbdt.split_scan": ROUNDS * DEPTH, "gbdt.route": ROUNDS * DEPTH,
         "gbdt.leaf": ROUNDS, "gbdt.draw": ROUNDS * (1 + DEPTH),
         "gbdt.predict": 1})
    assert collection_off.events() == []
    # outside a capture the switch is off again
    assert telemetry.span("gbdt.round") is telemetry._NULL_SPAN


def test_span_times_convert_to_the_profilers_clock(collection, tmp_path):
    trace = _profiled_fit(tmp_path)
    spans = collection.chrome_trace()["traceEvents"]
    wall_epoch_s, = [e["args"]["wall_epoch_s"] for e in spans
                     if e["name"] == "clock_sync"]
    shift_us = (wall_epoch_s - trace["baseTimeNanoseconds"] / 1e9) * 1e6
    marks = [e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("gbdt.")]
    mine = [e for e in spans if e.get("ph") == "X"]
    assert len(mine) == len(marks) > 0
    for name in ("gbdt.round", "gbdt.hist", "gbdt.draw", "gbdt.predict"):
        ours = sorted(e["ts"] for e in mine if e["name"] == name)
        theirs = sorted(float(e["ts"]) for e in marks if e["name"] == name)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert abs(a + shift_us - b) < 1000.0, name
