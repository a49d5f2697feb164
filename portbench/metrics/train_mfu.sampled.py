"""The sampled training cells' ``train_mfu``: the same reader, moving
``train_row_rounds_per_s.sampled``, the rate those cells report (their
host waits spread its runs wider than the unsampled cells')."""

from portbench.harness import load_metric

read = load_metric("train_mfu").read
