"""``non_hist_ms`` (ms/round): a round's stream time outside the
histograms: the split scan, routing, leaf sums, gradients and draws of
``_build_tree`` and ``_round``.  The traced call's time less the
``grad_histogram`` spans, per round."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("hist_calls"):
        return None
    return (ctx["call_ms"] - ctx["hist_ms"]) / ctx["rounds"]
