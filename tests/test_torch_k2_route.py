"""K2 (``grad_hist_cuda``) on K3's kernel, and the probe that keeps K1.

On the card K2 launches the kernel behind ``grad_hist_fused_cuda`` over
every node in one launch, so K2 and K3 give the same bits and no W matrix
is built; K1 (``hist_matmul_cuda``) stays the port of
``hist_matmul_pallas`` for a W the caller gives, and ``kernels_available``
still builds and checks it.  The CPU tests check the route and the probe's
cases; the ``cuda``-marked ones (``pytest -m cuda`` on a GPU machine) check
the bits and the launch counts on the card.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.ops import hist_cuda


def _inputs(rows, cols, num_nodes, num_bins, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, num_bins, (rows, cols)).astype(np.uint8)
    node = rng.randint(-1, num_nodes + 1, rows).astype(np.int32)
    g = rng.randn(rows).astype(np.float32)
    h = rng.rand(rows).astype(np.float32)
    return [torch.from_numpy(a) for a in (bins, node, g, h)]


@pytest.mark.parametrize("num_nodes,window", [(256, (0, None)),
                                              (37, (3, 2))])
def test_k2_is_one_call_of_k3_at_any_depth(monkeypatch, num_nodes, window):
    """K2 hands K3's wrapper every node and the window in one call, also
    where the reference's K2 would sweep node blocks (with no row list:
    dense)."""
    monkeypatch.setattr(hist_cuda, "_ACC_BYTES_LIMIT", 2 * 8 * 5 * 16 * 4)
    assert hist_cuda.hist_node_block(num_nodes, 5, 16) == 8
    args = _inputs(300, 5, num_nodes, 16, seed=num_nodes)
    calls = []
    fused = hist_cuda.grad_hist_fused_cuda

    def spy(*a, **kw):
        calls.append(a[4:])
        assert kw == {"rows": None, "offsets": None}
        return fused(*a, **kw)

    monkeypatch.setattr(hist_cuda, "grad_hist_fused_cuda", spy)
    got = hist_cuda.grad_hist_cuda(*args, num_nodes, 16, *window)
    assert calls == [(num_nodes, 16, *window)]
    want = fused(*args, num_nodes, 16, *window)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_probe_checks_k1_k2_and_k3():
    """``kernels_available`` runs every probe case on the card; here each
    case runs on the CPU, where wrapper and plain version agree bitwise."""
    cases = hist_cuda._probe_cases(torch.device("cpu"))
    names = sorted({label.split()[0] for label, _, _ in cases})
    assert names == ["grad_hist_cuda", "grad_hist_fused_cuda",
                     "hist_matmul_cuda"]
    assert any("columns (1, 1)" in label for label, _, _ in cases)
    hist_cuda.reset_launches()
    for label, kernel, plain in cases:
        got, want = kernel(), plain()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), label
    assert set(hist_cuda.LAUNCHES.values()) == {0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [(0, None), (14, 14)])
@pytest.mark.parametrize("num_nodes", [1, 5, 37, 256])
def test_k2_equals_k3_bitwise_on_card(card, num_nodes, window):
    """On the card K2 and K3 give the same bits, on all 28 columns and on
    the window 14..27; each K2 call is one K3 launch and no K1 launch."""
    args = [t.to(card) for t in _inputs(100_003, 28, num_nodes, 256,
                                        seed=num_nodes)]
    before = dict(hist_cuda.LAUNCHES)
    k2 = hist_cuda.grad_hist_cuda(*args, num_nodes, 256, *window)
    assert hist_cuda.LAUNCHES["grad_hist_fused_cuda"] == \
        before["grad_hist_fused_cuda"] + 1
    assert hist_cuda.LAUNCHES["hist_matmul_cuda"] == \
        before["hist_matmul_cuda"]
    k3 = hist_cuda.grad_hist_fused_cuda(*args, num_nodes, 256, *window)
    count = 28 - window[0] if window[1] is None else window[1]
    for a, b in zip(k2, k3):
        assert a.shape == (num_nodes, count, 256)
        assert torch.equal(a, b)
