"""The metrics' least work counts never exceed what the port itself moves,
so no share can pass 100% from the count alone: at tiny shapes on the CPU,
the histogram count against K3's launch plans for the same levels, the
round's count against K3 plus every other op of a port round, and the
scoring count against the ops of the port's ``predict``."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dmlc_core_tpu_torch.models import gbdt as port
from dmlc_core_tpu_torch.ops import hist_cuda
from portbench import data
from portbench.harness import load_metric
from portbench.kinds.train import _work

DATA = {"latent_factors": 4, "feature_noise": 1.0, "label_linear": 3,
        "label_pairs": 2, "label_noise": 0.5}
B, F, NB, DEPTH = 6000, 5, 32, 4


class Traffic(TorchDispatchMode):
    """Bytes every aten op reads and writes, and its comparisons."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.compares = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            for t in list(args) + [out]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
            if func.overloadpacket in (torch.ops.aten.gt,):
                self.compares += out.numel()
        return out


def _k3(num_nodes: int, rows: int):
    """Bytes and multiply-adds of one K3 launch, from its plan: the bins
    rows, node ids, g and h read, the partial sums written, and the dense
    product the tensor cores run."""
    plan = hist_cuda.grad_hist_fused_plan(num_nodes, rows, F, NB, 1)
    moved = rows * F + rows * 12 + plan.n_chunks * 2 * num_nodes * F * NB * 4
    ops = 2.0 * plan.m_blocks * plan.cols * rows * F * NB
    return moved, ops


def _fit(sub=1.0, col=1.0):
    bins, label = data.make_rows(DATA, B, F, NB, 4, "cpu")
    p = dict(objective="logistic", max_depth=DEPTH, learning_rate=0.3,
             num_bins=NB, hist_method="pallas", subsample=sub,
             colsample_bytree=col, colsample_bylevel=col, seed=9)
    model = port.GBDT(port.GBDTParam(**p), num_feature=F, device="cpu")
    ens, margin = model.append_rounds(None, bins, label, num_rounds=2)
    ctx = dict(_work(bins, tuple(ens[:4]), p, 0, 2, F), kind="train",
               rows=B, features=F, num_bins=NB, rounds=2,
               peak={"bytes_per_s": 1.0, "f32_flops_per_s": 1.0})
    return model, bins, label, ens, margin, ctx


def test_hist_count_is_at_most_k3s():
    for sub, col in ((1.0, 1.0), (0.8, 0.8)):
        *_, ctx = _fit(sub, col)
        least_b, least_ops = load_metric("hist_roofline").work(ctx)
        k3 = [_k3(2 ** d, B) for d in range(DEPTH)]
        assert 0 < least_b <= sum(m for m, _ in k3)
        assert 0 < least_ops <= sum(o for _, o in k3)


def test_round_count_is_at_most_a_port_round():
    model, bins, label, ens, margin, ctx = _fit()
    mode = Traffic()
    real = port.grad_histogram

    def uncounted(*a, **k):
        mode.paused = True
        try:
            return real(*a, **k)
        finally:
            mode.paused = False

    port.grad_histogram = uncounted
    try:
        with mode:
            model.append_rounds(ens, bins, label, num_rounds=1,
                                margin=margin)
    finally:
        port.grad_histogram = real
    k3 = sum(_k3(2 ** d, B)[0] for d in range(DEPTH))
    mfu = load_metric("train_mfu")
    hist_b, _ = load_metric("hist_roofline").work(ctx)
    assert hist_b + mfu.ROW_STATE_BYTES * B <= k3 + mode.bytes


def test_score_count_is_at_most_predicts():
    bins, _ = data.make_rows(DATA, B, F, NB, 5, "cpu", with_label=False)
    trees = data.make_ensemble(6, DEPTH, F, NB, 0.1, 5, "cpu")
    model = port.GBDT(port.GBDTParam(max_depth=DEPTH, num_bins=NB),
                      num_feature=F, device="cpu")
    mode = Traffic()
    with mode:
        model.predict(port.TreeEnsemble(*trees), bins)
    least_b, least_ops = load_metric("score_mfu").work(
        {"rows": B, "features": F, "trees": 6, "depth": DEPTH})
    assert 0 < least_b <= mode.bytes
    assert 0 < least_ops <= mode.compares
