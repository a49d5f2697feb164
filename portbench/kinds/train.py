"""Training cells: one boosting job continued through the window.

Set-up makes the rows and labels from the seed on the card, builds the
port's ``GBDT`` and grows ``warmup_rounds`` trees through
``GBDT.append_rounds`` (the first call builds and checks the histogram
kernels; every later round has the same shapes).  The window continues that
same job from the warm-up's ensemble and margin in calls of
``chunk_rounds`` rounds, back to back, until ``--seconds`` have passed, and
ends in a synchronise.  ``train_row_rounds_per_s`` is rows x rounds over
the window's time; ``peak_mem_gib`` the allocator's peak over the window.

A traced run runs the window's first call under the profiler, with a span
around every ``grad_histogram`` call that ``models.gbdt`` makes and around
the call itself, and counts the rows of every node of that call's trees
(the reference's routing) for the metrics' work counts.

Once the window has closed and the model is freed, the reference judges
the whole ensemble (:func:`portbench.reference.check.judge_train`), with
the splits of the first tree and of ``check_trees`` window trees drawn
from the seed.
"""

from __future__ import annotations

import random
import time


from portbench import data, trace
from portbench.kinds import free, peak_bytes, reset_peak, sync, timings
from portbench.reference import check, gbdt as ref


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float):
    marks = [time.perf_counter()]
    from dmlc_core_tpu_torch.models import gbdt as port_gbdt

    marks.append(time.perf_counter())
    cfg, spec = cell.config, cell.spec
    params = dict(cell.params(), seed=seed)
    ref.check_supported(params)
    rows, features = int(cfg["rows"]), int(cfg["features"])
    bins, label = data.make_rows(cfg["data"], rows, features,
                                 params["num_bins"], seed, device)
    sync(device)
    marks.append(time.perf_counter())
    model = port_gbdt.GBDT(port_gbdt.GBDTParam(**params),
                           num_feature=features, device=device)
    ens, margin = model.append_rounds(None, bins, label, num_rounds=1)
    for _ in range(int(spec["warmup_rounds"]) - 1):
        ens, margin = model.append_rounds(ens, bins, label, num_rounds=1,
                                          margin=margin)
    first = ens.num_trees
    chunk = int(spec["chunk_rounds"])

    def step():
        nonlocal ens, margin
        ens, margin = model.append_rounds(ens, bins, label,
                                          num_rounds=chunk, margin=margin)

    sync(device)
    reset_peak(device)
    start = time.perf_counter()
    setup_s = start - t0
    calls = 0
    profile = None
    while calls == 0 or time.perf_counter() - start < seconds:
        if traced and calls == 0:
            profile = _traced_call(step, port_gbdt, device)
        else:
            step()
        calls += 1
    sync(device)
    window_s = time.perf_counter() - start
    peak = peak_bytes(device)
    rounds = calls * chunk
    trees = tuple(ens[:4])
    del model, ens
    free(device)

    out = {"setup_s": setup_s, "attempted": rounds, "failed": 0,
           "memory_peak_bytes": peak,
           "end_to_end": {"train_row_rounds_per_s": rows * rounds / window_s,
                          "peak_mem_gib": peak / 2 ** 30}}
    if traced:
        profile.update(_work(bins, trees, params, first, chunk, features),
                       kind="train", rows=rows, features=features,
                       num_bins=params["num_bins"], rounds=chunk)
        out["trace"] = profile
    judged = time.perf_counter()
    out["checks"] = check.judge_train(
        bins, label, trees, margin, params, first + rounds,
        checked_trees(seed, first, trees[0].shape[0], spec["check_trees"]),
        cfg["hist_dtype"])
    out["seconds"] = timings(t0, marks, start, window_s, judged)
    return out


def checked_trees(seed: int, first: int, total: int, count: int):
    """The trees whose splits the reference recomputes: the job's first
    (grown from the base margin alone) and ``count`` of the window's trees
    ``[first, total)``, drawn from the seed."""
    window = list(range(first, total))
    return [0] + random.Random(seed).sample(window, min(int(count),
                                                        len(window)))


def _traced_call(step, port_gbdt, device):
    """``step()`` under the profiler, with spans around it and around each
    ``grad_histogram`` that ``models.gbdt`` calls."""
    spans = trace.Spans(device)
    hist = port_gbdt.grad_histogram
    port_gbdt.grad_histogram = spans.wrap("hist", hist)

    def spanned():
        spans.start("call")
        step()
        spans.stop("call")

    try:
        prof = trace.profiled(spanned, device)
    finally:
        port_gbdt.grad_histogram = hist
    prof.update(call_ms=spans.total_ms("call"), hist_ms=spans.total_ms("hist"),
                hist_calls=spans.count("hist"))
    return prof


def _work(bins, trees, params, first: int, chunk: int, features: int):
    """Rows of every node and features allowed at every level of the traced
    call's trees, as the reference routes and draws them."""
    sf, sb = trees[0], trees[1]
    depth = params["max_depth"]
    node_rows, level_features = [], []
    for t in range(first, first + chunk):
        row_w, tree_mask = ref.tree_draws(params, t, bins.shape[0], features,
                                          bins.device)
        node_rows.append([c.tolist() for c in check.node_rows(
            bins, sf[t], sb[t], depth, row_w)])
        level_features.append([
            features if m is None else int(m.sum())
            for m in (ref.level_mask(params, t, d, features, tree_mask,
                                     bins.device) for d in range(depth))])
    return {"node_rows": node_rows, "level_features": level_features}
