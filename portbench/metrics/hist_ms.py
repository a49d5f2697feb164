"""``hist_ms`` (ms/round): stream time inside the ``grad_histogram`` calls
that ``models.gbdt`` makes (CUDA events around each), per round of the
traced call: the histogram layer, K3's kernel and its wrapper."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("hist_calls"):
        return None
    return ctx["hist_ms"] / ctx["rounds"]
