"""``hist_roofline.dp4`` (%): rank 0's histogram kernel against its least
time: ``hist_roofline``'s least time of a round's histograms over rank
0's rows over the device self time of the ``gbdt.hist`` spans a round
(the kernels, copies and sets launched in ``gbdt.hist`` and in no span
inside it: K3 without the histogram all-reduce, which runs in its inner
``collective.sum``)."""

from portbench.harness import load_metric

hist_roofline = load_metric("hist_roofline")


def read(ctx):
    if ctx.get("kind") != "train_dp" or not ctx.get("peak"):
        return None
    self_ms = ctx.get("span_device_ms", {}).get("gbdt.hist", 0.0)
    if self_ms <= 0.0:
        return None
    return 100.0 * hist_roofline.least_s(ctx) / (self_ms / 1e3
                                                 / ctx["rounds"])
