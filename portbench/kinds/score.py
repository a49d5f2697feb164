"""Scoring cells: batch scoring of a table with a trained-size model.

Set-up makes a ``table_rows`` x F table of bins and a full ensemble of
``trees`` trees (random splits and leaf values, like random weights) from
the seed on the card, and scores one batch to warm up.  The window scores
consecutive batches of ``batch_rows`` rows through ``GBDT.predict``, back
to back in a closed loop, cycling over the table, and writes each batch's
scores into the table's score column; it ends in a synchronise.
``score_rows_per_s`` is rows scored over the window's time.

A traced run runs the window's first call under the profiler.  Once the
window has closed, ``check_batches`` of the scored batches, drawn from the
seed, are judged against the reference's scores.
"""

from __future__ import annotations

import random
import time

import torch

from portbench import data, trace
from portbench.kinds import free, peak_bytes, reset_peak, sync, timings
from portbench.reference import check


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float):
    marks = [time.perf_counter()]
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble

    marks.append(time.perf_counter())
    cfg, spec = cell.config, cell.spec
    params = cell.params()
    features, depth = int(cfg["features"]), params["max_depth"]
    table_rows, batch = int(spec["table_rows"]), int(spec["batch_rows"])
    if table_rows % batch:
        raise SystemExit("table_rows must be a multiple of batch_rows")
    bins, _ = data.make_rows(cfg["data"], table_rows, features,
                             params["num_bins"], seed, device,
                             with_label=False)
    trees = data.make_ensemble(int(spec["trees"]), depth, features,
                               params["num_bins"], float(spec["leaf_scale"]),
                               seed, device)
    ens = TreeEnsemble(*trees)
    sync(device)
    marks.append(time.perf_counter())
    model = GBDT(GBDTParam(**params), num_feature=features, device=device)
    scores = torch.zeros(table_rows, dtype=torch.float32, device=device)
    n_batches = table_rows // batch

    def step(i: int):
        sl = slice((i % n_batches) * batch, (i % n_batches + 1) * batch)
        scores[sl].copy_(model.predict(ens, bins[sl]))

    step(0)
    sync(device)
    reset_peak(device)
    start = time.perf_counter()
    setup_s = start - t0
    calls = 0
    profile = None
    while calls == 0 or time.perf_counter() - start < seconds:
        if traced and calls == 0:
            spans = trace.Spans(device)

            def spanned():
                spans.start("call")
                step(0)
                spans.stop("call")

            profile = trace.profiled(spanned, device)
            profile.update(call_ms=spans.total_ms("call"))
        else:
            step(calls)
        calls += 1
    sync(device)
    window_s = time.perf_counter() - start
    peak = peak_bytes(device)
    del model
    free(device)

    out = {"setup_s": setup_s, "attempted": calls, "failed": 0,
           "memory_peak_bytes": peak,
           "end_to_end": {"score_rows_per_s": calls * batch / window_s,
                          "peak_mem_gib": peak / 2 ** 30}}
    if traced:
        profile.update(kind="score", calls=1, rows=batch, features=features,
                       trees=int(spec["trees"]), depth=depth)
        out["trace"] = profile
    judged = time.perf_counter()
    scored = list(range(min(calls, n_batches)))
    worst = {}
    for b in random.Random(seed).sample(
            scored, min(int(spec["check_batches"]), len(scored))):
        sl = slice(b * batch, (b + 1) * batch)
        for k, v in check.judge_score(bins[sl], trees, scores[sl],
                                      depth).items():
            worst[k] = max(worst.get(k, 0.0), v)
    out["checks"] = worst
    out["seconds"] = timings(t0, marks, start, window_s, judged)
    return out
