"""``device_idle_frac.dp4`` (%): the share of rank 0's traced window call
in which no kernel, copy or set ran on its card (profiler trace); time an
NCCL kernel spends waiting for a peer counts as busy."""


def read(ctx):
    if ctx.get("kind") != "train_dp" or not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
