"""``launches_per_round`` (launches): device operations (kernels, copies
and sets) the profiler saw in the traced call, per round: how much the
host dispatches for ``_round``."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("device_ops"):
        return None
    return ctx["device_ops"] / ctx["rounds"]
