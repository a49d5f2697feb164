"""``allreduce_ms.dp4`` (ms/round): rank 0's device time of the
collectives a round, from the traced call.

Two readings, each of which can miss part of it, and the larger is
taken: the device time of the kernels, copies and sets launched inside
the port's ``collective.*`` spans or inside the ``nccl:<op>`` annotation
that ``torch.distributed`` opens within them (a launch the profiler does
not link to its runtime call lies in no span), and the device time of the
kernels named ``nccl*`` (which leaves out the copy an op makes of its
input).  An NCCL kernel spins until its peers arrive, so the time
includes any wait for a slower rank."""


def ms_per_round(ctx):
    """The reading above, or None where the call ran no collective on the
    device."""
    if ctx.get("kind") != "train_dp" or not ctx.get("device_ops"):
        return None
    in_spans = sum(ms for name, ms in ctx.get("span_device_ms", {}).items()
                   if name.startswith(("collective.", "nccl:")))
    nccl = 1e3 * sum(s for name, s in ctx["top_ops"]
                     if name.lower().startswith("nccl"))
    ms = max(in_spans, nccl)
    return ms / ctx["rounds"] if ms > 0.0 else None


def read(ctx):
    return ms_per_round(ctx)
