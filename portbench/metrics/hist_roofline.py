"""``hist_roofline`` (%): the histogram layer's least time over its time.

The least work of a round's histograms, whatever implements them (so no
kernel can read above 100%):

- level 0 reads every row's bins over the level's allowed features and
  its g and h (f32 each), and writes one histogram;
- each deeper level reads the rows of the smaller child of every node
  split at the level above (the larger child is its parent less the
  smaller, so it needs no rows), and writes the smaller child's histogram;
  a node left unsplit hands its histogram on unread;
- a histogram is ``features x num_bins`` (G, H) pairs of f32; the
  operations are two adds per (row, feature).

Rows are counted by routing the rows through the traced call's own trees
(a row of weight 0 counts for none); features are those the level may
split on.  The least time is the larger of bytes over the card's memory
bandwidth and operations over its f32 rate; the time is the summed stream
time of the traced call's ``grad_histogram`` calls.
"""


def work(ctx):
    """(bytes, operations) of one round's histograms, the traced rounds'
    mean."""
    nb = ctx["num_bins"]
    total_b = total_ops = 0.0
    for rows, feats in zip(ctx["node_rows"], ctx["level_features"]):
        for d, (counts, f) in enumerate(zip(rows, feats)):
            if d == 0:
                read, built = counts[0], 1
            else:
                above = rows[d - 1]
                smaller = [min(counts[2 * i], counts[2 * i + 1])
                           for i in range(len(above))]
                read = sum(smaller)
                built = sum(1 for s in smaller if s > 0)
            total_b += read * (f + 8) + built * f * nb * 8
            total_ops += 2.0 * read * f
    n = len(ctx["node_rows"])
    return total_b / n, total_ops / n


def least_s(ctx, extra_bytes: float = 0.0):
    """Least seconds of a round's histograms plus ``extra_bytes``."""
    b, ops = work(ctx)
    peak = ctx["peak"]
    return max((b + extra_bytes) / peak["bytes_per_s"],
               ops / peak["f32_flops_per_s"])


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peak") \
            or ctx.get("hist_ms", 0.0) <= 0.0:
        return None
    hist_s = ctx["hist_ms"] / 1e3 / ctx["rounds"]
    return 100.0 * least_s(ctx) / hist_s
