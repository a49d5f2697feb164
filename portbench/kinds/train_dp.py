"""Training sharded by rows: one boosting job over several ranks, each a
card, continued through the window.

The harness's process is rank 0; it starts ranks ``1 .. ranks-1`` as
child interpreters (:mod:`portbench.ranks`).  Every rank
fits as a tracker-launched worker of the port does: ``collective.init``
(NCCL, one card a rank, or gloo on the CPU), ``make_mesh(spec["mesh"])``,
then ``GBDT.append_rounds`` on its own shard under ``with mesh:``, so every
level's histograms and the leaf sums are all-reduced over the mesh's
``data`` axis and every rank grows the same trees.  Each rank makes its
shard on its own device (:func:`portbench.shards.make_shard`): one table
from the seed, split by rows.

Set-up grows ``warmup_rounds`` trees.  The window starts after a barrier
and continues the job in calls of ``chunk_rounds`` rounds; after each call
rank 0 synchronises, decides on its clock whether to go on and shares the
decision in one one-element broadcast, so every rank makes the same
calls.  It ends in a synchronise and a barrier.
``train_row_rounds_per_s`` is every rank's rows x rounds over rank 0's
window; ``peak_mem_gib`` the fullest card's allocator peak over the window.

A traced run runs rank 0's first window call under the profiler with the
spans of ``kinds/train.py`` and the port's telemetry on, reduces its trace
by program span as well (:func:`portbench.spans.reduce_spans`), reads the
collectives' payload counter, and counts the rows of every node of that
call's trees on rank 0's shard for the metrics' work counts.  Reading the
trace takes longer than the window, so a traced run's window goes on for
``--seconds`` after the traced call: the job then grows, and the judge
weighs, as many trees as in an untraced run (``leaf_err_med`` is a median
over trees, and over the four trees of one call it is the first trees',
whose leaf sums cancel).

Once the window has closed and the model is freed, every rank judges its
rows with the sharded reference
(:func:`portbench.reference.check_dp.judge_train_dp`), the first tree and
``check_trees`` window trees drawn from the seed checked level by level.
Each child then hands rank 0 its peak and whether it loaded JAX or the JAX
package, in one all-gather; every rank leaves the process group, and the
children exit.
"""

from __future__ import annotations

import sys
import time

import torch
import torch.distributed as dist

from portbench import ranks, shards, spans, trace
from portbench.kinds import (free, on_card, peak_bytes, reset_peak, sync,
                             timings, train)
from portbench.reference import check_dp, gbdt as ref

# seconds the children have to exit once rank 0 is done with them
EXIT_S = 60


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float):
    """Rank 0, in the harness's process."""
    args = {"config": cell.config, "spec": cell.spec,
            "params": cell.params(), "seed": seed, "seconds": seconds,
            "traced": traced, "device": str(device)}
    with ranks.Job("portbench.kinds.train_dp:child", args,
                   int(cell.config["ranks"])) as job:
        out = _rank(args, job.env, t0)
        job.finish(EXIT_S)
    return out


def child(args) -> None:
    """Ranks 1 and up, each in a child interpreter."""
    _rank(args, {}, time.perf_counter())


def _rank(args, env, t0: float):
    """One rank's job; ``env`` overrides the DMLC variables of the
    process's environment.  Returns rank 0's result (None elsewhere)."""
    from portbench.harness import _loaded_forbidden

    marks = [time.perf_counter()]
    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.models import gbdt as port_gbdt
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    cfg, spec, seed = args["config"], args["spec"], args["seed"]
    cuda = on_card(args["device"])
    init = dict(env, timeout=float(spec["collective_timeout_s"]))
    if not cuda:
        init["device"] = "cpu"
    collective.init(init)
    rank, world = collective.get_rank(), collective.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    mesh = make_mesh(spec["mesh"])
    marks.append(time.perf_counter())
    params = dict(args["params"], seed=seed)
    ref.check_supported(params)
    rows, features = int(cfg["rows_per_rank"]), int(cfg["features"])
    bins, label = shards.make_shard(cfg["data"], rows, features,
                                    params["num_bins"], seed, rank, dev)
    sync(dev)
    marks.append(time.perf_counter())
    model = port_gbdt.GBDT(port_gbdt.GBDTParam(**params),
                           num_feature=features, device=dev)
    chunk = int(spec["chunk_rounds"])
    with mesh:
        ens, margin = model.append_rounds(None, bins, label, num_rounds=1)
        for _ in range(int(spec["warmup_rounds"]) - 1):
            ens, margin = model.append_rounds(ens, bins, label,
                                              num_rounds=1, margin=margin)
        first = ens.num_trees

        def step():
            nonlocal ens, margin
            ens, margin = model.append_rounds(ens, bins, label,
                                              num_rounds=chunk,
                                              margin=margin)

        _barrier(dev)
        reset_peak(dev)
        start = clock = time.perf_counter()
        setup_s = start - t0
        calls = 0
        profile = None
        while True:
            if args["traced"] and rank == 0 and calls == 0:
                profile = _traced_call(step, port_gbdt, dev)
                clock = time.perf_counter()
            else:
                step()
            calls += 1
            if not _go_on(rank, clock, args["seconds"], dev):
                break
        _barrier(dev)
    window_s = time.perf_counter() - start
    peak = peak_bytes(dev)
    rounds = calls * chunk
    trees = tuple(ens[:4])
    del model, ens
    free(dev)

    if profile is not None:
        profile.update(train._work(bins, trees, params, first, chunk,
                                   features),
                       kind="train_dp", rows=rows, features=features,
                       num_bins=params["num_bins"], rounds=chunk,
                       ranks=world)
    judged = time.perf_counter()
    checks = check_dp.judge_train_dp(
        bins, label, trees, margin, params, first + rounds,
        train.checked_trees(seed, first, trees[0].shape[0],
                            spec["check_trees"]),
        cfg["hist_dtype"])
    # every rank's peak and whether it loaded a forbidden module
    mine = torch.tensor([float(peak), float(bool(_loaded_forbidden()))],
                        dtype=torch.float64, device=dev)
    reports = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(reports, mine)
    collective.finalize()
    if rank != 0:
        return None
    bad = [r for r, rep in enumerate(reports) if rep[1] > 0]
    if bad:
        print(f"portbench: rank(s) {bad} loaded JAX or the JAX package",
              file=sys.stderr)
        raise SystemExit(3)
    peak = max(int(rep[0]) for rep in reports)
    out = {"setup_s": setup_s, "attempted": rounds, "failed": 0,
           "memory_peak_bytes": peak,
           "end_to_end": {
               "train_row_rounds_per_s": world * rows * rounds / window_s,
               "peak_mem_gib": peak / 2 ** 30},
           "checks": checks,
           "seconds": timings(t0, marks, start, window_s, judged)}
    if profile is not None:
        out["trace"] = profile
    return out


def _barrier(dev) -> None:
    sync(dev)
    dist.barrier()
    sync(dev)


def _go_on(rank: int, clock: float, seconds: float, dev) -> bool:
    """Rank 0's decision (``seconds`` past ``clock`` or not yet), after its
    card has drained, shared with every rank."""
    go = 1
    if rank == 0:
        sync(dev)
        go = int(time.perf_counter() - clock < seconds)
    flag = torch.tensor([go], dtype=torch.int32, device=dev)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _traced_call(step, port_gbdt, dev):
    """:func:`portbench.kinds.train._traced_call` with the trace also
    reduced by program span and the port's telemetry on for the call;
    ``collective_payload_bytes`` is what the call's collectives counted
    (None where the program counts none)."""
    from dmlc_core_tpu_torch import telemetry

    plain = trace.reduce_trace

    def by_span(events):
        out = plain(events)
        out.update(spans.reduce_spans(events))
        return out

    trace.reduce_trace = by_span
    telemetry.reset()
    telemetry.enable()
    try:
        prof = train._traced_call(step, port_gbdt, dev)
        family = telemetry.snapshot()["metrics"].get(
            "dmlc_collective_payload_bytes_total", {"samples": []})
        payload = sum(s["value"] for s in family["samples"])
    finally:
        telemetry.disable()
        telemetry.reset()
        trace.reduce_trace = plain
    prof["collective_payload_bytes"] = payload or None
    return prof
