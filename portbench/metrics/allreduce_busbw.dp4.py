"""``allreduce_busbw.dp4`` (%): the collectives' bus bandwidth over the
link's peak, the collective layer's share of its roofline.

The bytes are what the port's collectives counted in rank 0's traced call
(``dmlc_collective_payload_bytes_total``: each op's tensor on this rank),
times ``2 (n - 1) / n`` for ``n`` ranks, which is what a ring all-reduce
moves over each rank's link each way (NCCL's bus bandwidth); the time is
``allreduce_ms.dp4``'s.  The peak is one direction of the card's NVLink.
A host whose cards are joined by PCIe reads low against it; the count
and the formula keep the share under 100%."""

from portbench.harness import load_metric

allreduce_ms = load_metric("allreduce_ms.dp4")

# NVIDIA H100 Tensor Core GPU datasheet, SXM5: fourth-generation NVLink,
# 900 GB/s of total bandwidth a card, 450 GB/s each way
LINK_BYTES_PER_S = 450e9


def read(ctx):
    ms = allreduce_ms.ms_per_round(ctx)
    payload = ctx.get("collective_payload_bytes")
    if ms is None or not payload:
        return None
    n = ctx["ranks"]
    moved = payload / ctx["rounds"] * 2.0 * (n - 1) / n
    return 100.0 * moved / (ms / 1e3) / LINK_BYTES_PER_S
