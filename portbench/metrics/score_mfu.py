"""``score_mfu`` (%): a ``GBDT.predict`` call's least time over its time.

The least work of scoring a batch, whatever implements it: read every
row's bins once and write its score (f32) once, and make one comparison
per row, tree and level.  The least time is the larger of bytes over the
card's memory bandwidth and comparisons over its f32 rate; the time is the
traced call's stream time.
"""


def work(ctx):
    """(bytes, operations) of one call."""
    rows = ctx["rows"]
    return (rows * (ctx["features"] + 4),
            float(rows) * ctx["trees"] * ctx["depth"])


def read(ctx):
    if ctx.get("kind") != "score" or not ctx.get("peak") \
            or ctx.get("call_ms", 0.0) <= 0.0:
        return None
    b, ops = work(ctx)
    peak = ctx["peak"]
    least = max(b / peak["bytes_per_s"], ops / peak["f32_flops_per_s"])
    return 100.0 * least / (ctx["call_ms"] / 1e3 / ctx["calls"])
