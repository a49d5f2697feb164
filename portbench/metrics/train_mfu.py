"""``train_mfu`` (%): a whole boosting round's least time over its time.

The least work of a round: its histograms' (``hist_roofline``'s count)
plus one pass over the per-row state that every round must touch: read
and write the margin (f32), read the label (f32) and write g and h (f32
each), 20 bytes a row.  The time is the traced call's stream time over
its rounds.  The split scan and leaf sums add no bytes of their own to the
least count, so this share bounds a gain in any part of the round.
"""

from portbench.harness import load_metric

hist_roofline = load_metric("hist_roofline")
ROW_STATE_BYTES = 20


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("peak") \
            or ctx.get("call_ms", 0.0) <= 0.0:
        return None
    round_s = ctx["call_ms"] / 1e3 / ctx["rounds"]
    least = hist_roofline.least_s(ctx, ROW_STATE_BYTES * ctx["rows"])
    return 100.0 * least / round_s
