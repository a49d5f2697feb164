"""``train_mfu.dp4`` (%): the share of the whole sharded step's peak that
rank 0's round reaches: ``train_mfu``'s least time of a round over rank
0's rows (its histograms as ``hist_roofline`` counts them, plus 20 B a
row of margin, label, g and h) over rank 0's round, the traced call's
stream time over its rounds.  The round's time includes the all-reduces
and any wait for a slower rank, so this share bounds a gain in any part
of the sharded round."""

from portbench.harness import load_metric

hist_roofline = load_metric("hist_roofline")
train_mfu = load_metric("train_mfu")


def read(ctx):
    if ctx.get("kind") != "train_dp" or not ctx.get("peak") \
            or ctx.get("call_ms", 0.0) <= 0.0:
        return None
    round_s = ctx["call_ms"] / 1e3 / ctx["rounds"]
    least = hist_roofline.least_s(ctx,
                                  train_mfu.ROW_STATE_BYTES * ctx["rows"])
    return 100.0 * least / round_s
