"""``launches_per_call.score`` (launches): device operations (kernels,
copies and sets) the profiler saw in one ``GBDT.predict`` call: the host
dispatch of ``predict_margin`` and ``_route_tree``."""


def read(ctx):
    if ctx.get("kind") != "score" or not ctx.get("device_ops"):
        return None
    return ctx["device_ops"] / ctx["calls"]
