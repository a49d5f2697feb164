"""``device_idle_frac.train`` (%): the share of the traced training call in
which no kernel, copy or set ran on the card (profiler trace)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
