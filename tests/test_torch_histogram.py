"""PyTorch port vs the JAX package: binning, quantiles and histograms.

Every case makes its inputs from a seed with numpy and feeds the same
arrays to the JAX function (on the CPU; Pallas kernels in interpret mode)
and to the port (``device="cpu"``, the kernels' plain versions).
Tolerances: binning and quantiles are bitwise; the exact scatter agrees to
rtol 1e-6 (f32 sums in another order); the bf16 methods to rtol/atol 1e-5
(the same bf16 inputs, only the f32 summation order differs).
"""

import contextlib

import numpy as np
import pytest
import torch

from dmlc_core_tpu.bridge import binning as jax_binning
from dmlc_core_tpu.ops import hist_pallas
from dmlc_core_tpu.ops import histogram as jax_hist
from dmlc_core_tpu_torch.bridge import binning as port_binning
from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.ops import histogram as port_hist


@pytest.fixture
def interpret_mode():
    hist_pallas._INTERPRET = True
    for probe in (hist_pallas.pallas_supported,
                  hist_pallas.pallas_fused_supported,
                  hist_pallas.pallas_i8_supported):
        probe.cache_clear()
    yield
    hist_pallas._INTERPRET = False
    for probe in (hist_pallas.pallas_supported,
                  hist_pallas.pallas_fused_supported,
                  hist_pallas.pallas_i8_supported):
        probe.cache_clear()


def _case(b, f, nbins, nnodes, seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nbins, (b, f)).astype(np.int32)
    node = rng.randint(0, nnodes, b).astype(np.int32)
    g = rng.randn(b).astype(np.float32)
    h = rng.rand(b).astype(np.float32)
    return bins, node, g, h


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol, atol=0.0):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _edge_values(rng, bounds, n):
    """Random values plus NaN, +-inf and values exactly on boundaries."""
    F = bounds.shape[0]
    x = rng.randn(n, F).astype(np.float32) * 2
    x[::7, 0] = np.nan
    x[1::11, -1] = np.inf
    x[2::13, 1] = -np.inf
    for f in range(F):
        x[3:3 + bounds.shape[1], f] = bounds[f]        # exact-boundary ties
    return x


# -- binning and quantiles (bitwise) ------------------------------------------
@pytest.mark.parametrize("missing_bin", [None, 15])
def test_apply_bins_bitwise(missing_bin):
    rng = np.random.RandomState(1)
    nb = 15 if missing_bin is not None else 16
    bounds = jax_hist.quantile_boundaries(rng.randn(500, 4), nb)
    x = _edge_values(rng, bounds, 400)
    want = np.asarray(jax_hist.apply_bins(x, bounds, missing_bin=missing_bin))
    got = port_hist.apply_bins(x, bounds, missing_bin=missing_bin,
                               device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    nan_ids = got.numpy()[np.isnan(x[:, 0]), 0]
    # NaN lands in the last bin, or takes the reserved missing id
    assert (nan_ids == (nb - 1 if missing_bin is None else missing_bin)).all()


@pytest.mark.parametrize("with_nan", [False, True])
def test_quantile_boundaries_bitwise(with_nan):
    rng = np.random.RandomState(2)
    sample = rng.standard_cauchy((700, 5)).astype(np.float32)
    sample[:, 2] = 3.0                                   # constant feature
    if with_nan:
        sample[::3, 1] = np.nan
        sample[:, 4] = np.nan                            # all-missing
    for nb in (8, 32):
        np.testing.assert_array_equal(
            port_hist.quantile_boundaries(sample, nb),
            jax_hist.quantile_boundaries(sample, nb))


def test_mergeable_quantiles_bitwise():
    rng = np.random.RandomState(3)
    shards = [rng.randn(n, 3).astype(np.float32) * (i + 1)
              for i, n in enumerate((300, 120, 0))]
    shards[1][::4, 0] = np.nan
    pts, cnts = [], []
    for s in shards:
        p_port, c_port = port_hist.local_quantile_summary(s, 64)
        p_jax, c_jax = jax_hist.local_quantile_summary(s, 64)
        np.testing.assert_array_equal(p_port, p_jax)
        np.testing.assert_array_equal(c_port, c_jax)
        pts.append(p_port)
        cnts.append(c_port)
    np.testing.assert_array_equal(
        port_hist.merged_quantile_boundaries(np.stack(pts), np.stack(cnts),
                                             16),
        jax_hist.merged_quantile_boundaries(np.stack(pts), np.stack(cnts),
                                            16))


@pytest.mark.parametrize("num_bins,handle_missing", [
    (16, False), (256, False), (256, True), (300, False)])
def test_host_binner_byte_identical(num_bins, handle_missing):
    rng = np.random.RandomState(4)
    eff = num_bins - 1 if handle_missing else num_bins
    bounds = jax_hist.quantile_boundaries(rng.randn(2000, 3), eff)
    x = _edge_values(rng, bounds, 1500)
    want = jax_binning.HostBinner(bounds, num_bins,
                                  handle_missing).transform(x)
    got = port_binning.HostBinner(bounds, num_bins,
                                  handle_missing).transform(x)
    assert got.dtype == want.dtype == jax_binning.wire_dtype(num_bins)
    assert got.tobytes() == want.tobytes()
    assert port_binning.wire_dtype(num_bins) == jax_binning.wire_dtype(
        num_bins)
    # the host wire agrees with on-device binning too
    miss = num_bins - 1 if handle_missing else None
    np.testing.assert_array_equal(
        port_hist.apply_bins(x, bounds, missing_bin=miss,
                             device="cpu").numpy(), got.astype(np.int32))


def test_bin_onehot_equal():
    bins, _, _, _ = _case(50, 3, 8, 1, seed=5)
    got = port_hist.bin_onehot(torch.from_numpy(bins), 8)
    want = np.asarray(jax_hist.bin_onehot(bins, 8).astype(np.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


# -- grad_histogram methods ---------------------------------------------------
@pytest.mark.parametrize("b,f,nbins,nnodes", [
    (300, 5, 16, 2), (1000, 3, 32, 8), (700, 4, 8, 12)])
def test_scatter_matches_jax(b, f, nbins, nnodes):
    bins, node, g, h = _case(b, f, nbins, nnodes, seed=b)
    want = jax_hist.grad_histogram(bins, node, g, h, nnodes, nbins,
                                   method="scatter")
    got = port_hist.grad_histogram(*_t(bins, node, g, h), nnodes, nbins,
                                   method="scatter", device="cpu")
    assert got[0].shape == (nnodes, f, nbins)
    _close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,f,nbins,nnodes", [(300, 5, 16, 2),
                                              (800, 3, 32, 4)])
def test_onehot_matches_jax(b, f, nbins, nnodes):
    bins, node, g, h = _case(b, f, nbins, nnodes, seed=b + 1)
    want = jax_hist.grad_histogram(bins, node, g, h, nnodes, nbins,
                                   method="onehot")
    got = port_hist.grad_histogram(*_t(bins, node, g, h), nnodes, nbins,
                                   method="onehot", device="cpu")
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_auto_resolves_to_scatter_on_cpu():
    bins = torch.zeros((4, 2), dtype=torch.int32)
    assert port_hist.resolve_hist_method("auto", bins) == "scatter"
    assert port_hist.resolve_hist_method("pallas", bins) == "pallas"
    with pytest.raises(RuntimeError):
        port_hist.resolve_hist_method("bogus", bins)


def test_model_axis_takes_k4_plain_version(monkeypatch):
    """``grad_histogram(model_axis=...)`` under a 1 x 1 mesh dispatches to
    K4, whose wrapper takes its plain version for CPU tensors and counts
    no launch; the result is the plain histogram, bitwise."""
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    bins, node, g, h = _case(64, 4, 8, 3, seed=7)
    calls = []
    plain = hist_cuda.grad_hist_sharded_ref

    def spy(*args, **kwargs):
        calls.append(args[7])                            # the mesh
        return plain(*args, **kwargs)

    monkeypatch.setattr(hist_cuda, "grad_hist_sharded_ref", spy)
    hist_cuda.reset_launches()
    with make_mesh({"data": 1, "model": 1}):
        got = port_hist.grad_histogram(*_t(bins, node, g, h), 3, 8,
                                       model_axis="model", method="pallas",
                                       device="cpu")
    assert len(calls) == 1
    assert set(hist_cuda.LAUNCHES.values()) == {0}
    want = hist_cuda.grad_hist_ref(*_t(bins, node, g, h), 3, 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _CardBins(torch.Tensor):
    """CPU bins that report the card as their device: what ``"auto"``
    decides from, without a card."""

    @property
    def device(self):
        return torch.device("cuda")


# name: method, bins' device, model_axis, ambient mesh, bins width and bin
# count, then the plan: method, whether K4 runs
PLAN_TABLE = {
    "auto on the CPU": ("auto", "cpu", None, None, (4, 8), "scatter", False),
    "auto on the card": ("auto", "cuda", None, None, (4, 8), "pallas",
                         False),
    "pallas": ("pallas", "cpu", None, None, (4, 8), "pallas", False),
    "pallas_fused": ("pallas_fused", "cpu", None, None, (4, 8),
                     "pallas_fused", False),
    "onehot": ("onehot", "cpu", None, None, (4, 8), "onehot", False),
    "scatter": ("scatter", "cpu", None, None, (4, 8), "scatter", False),
    "pallas on K4": ("pallas", "cpu", "model", {"data": 1, "model": 1},
                     (4, 8), "pallas", True),
    "pallas_fused on K4": ("pallas_fused", "cpu", "model",
                           {"data": 1, "model": 1}, (4, 8), "pallas_fused",
                           True),
    "pallas, no mesh": ("pallas", "cpu", "model", None, (4, 8), "onehot",
                        False),
    "pallas_fused, axis not in the mesh": (
        "pallas_fused", "cpu", "tensor", {"data": 1, "model": 1}, (4, 8),
        "onehot", False),
    # the reference's 8-node accumulator outgrows its budget at this width
    "pallas, too wide a shard": ("pallas", "cpu", "model",
                                 {"data": 1, "model": 1}, (130, 1024),
                                 "onehot", False),
    "onehot with model_axis": ("onehot", "cpu", "model",
                               {"data": 1, "model": 1}, (4, 8), "onehot",
                               False),
    "scatter with model_axis": ("scatter", "cpu", "model",
                                {"data": 1, "model": 1}, (4, 8), "scatter",
                                False),
}


@pytest.mark.parametrize("case", sorted(PLAN_TABLE))
def test_hist_plan_decision_table(monkeypatch, case):
    """``hist_plan`` resolves the method, holds K4's gate, carries the bin
    one-hot and picks the leaf-sum formulation, once; and its leaf sums
    are the per-leaf sums of g and h."""
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    method, where, axis, mesh_axes, (F, nb), want, k4 = PLAN_TABLE[case]
    probes = []
    monkeypatch.setattr(hist_cuda, "kernels_available",
                        lambda: probes.append(1) or True)
    gen = torch.Generator().manual_seed(3)
    bins = torch.randint(0, nb, (16, F), generator=gen, dtype=torch.int32)
    if where == "cuda":
        bins = bins.as_subclass(_CardBins)
    mesh = make_mesh(mesh_axes) if mesh_axes else None
    with mesh if mesh is not None else contextlib.nullcontext():
        plan = port_hist.hist_plan(method, bins, nb, axis, num_nodes=32)
    assert plan.method == want
    assert len(probes) == (where == "cuda" and method == "auto")
    assert (plan.mesh is mesh) if k4 else plan.mesh is None
    assert plan.model_axis == (axis if k4 else None)
    if want == "onehot":
        assert torch.equal(plan.onehot, port_hist.bin_onehot(bins, nb))
    else:
        assert plan.onehot is None
    # the matmul-shaped methods sum leaves by matmul, "scatter" by segments
    assert plan.leaf_matmul == (want != "scatter")
    # below the root the kernel methods off K4 read the listed rows alone
    lists = want in ("pallas", "pallas_fused") and not k4
    assert plan.lists_rows == lists
    assert port_hist.hist_plan(plan, bins, nb, axis) is plan
    if where == "cpu":
        node = torch.randint(-1, 5, (16,), generator=gen)
        g, h = torch.randn(16, generator=gen), torch.rand(16, generator=gen)
        G, H = port_hist.leaf_sums(plan, node, g, h, 4)
        for got, v in ((G, g), (H, h)):
            want_sums = torch.stack([v[node == i].sum() for i in range(4)])
            torch.testing.assert_close(got, want_sums, rtol=1e-6,
                                       atol=1e-6)


def test_hist_plan_refuses_unknown_methods():
    bins = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        port_hist.hist_plan("bogus", bins, 8)


# -- the kernels' plain versions vs the Pallas kernels (interpret mode) ------
KERNEL_CASES = [
    # b, f, nbins, nnodes, drop (-1 nodes), uint8 bins
    (256, 3, 8, 4, False, False),       # exactly one Pallas row tile
    (300, 5, 16, 2, False, False),      # row padding inside the wrapper
    (700, 2, 4, 8, True, False),        # multi-tile, -1 nodes drop out
    (500, 3, 16, 12, False, False),     # non-power-of-two node count
    (600, 3, 256, 5, True, True),       # uint8 bins carrying bin 255
]


@pytest.mark.parametrize("b,f,nbins,nnodes,drop,u8", KERNEL_CASES)
def test_grad_hist_ref_matches_pallas(interpret_mode, b, f, nbins, nnodes,
                                      drop, u8):
    bins, node, g, h = _case(b, f, nbins, nnodes, seed=b + nnodes)
    if drop:
        node[::5] = -1
    if u8:
        bins[::9, 0] = 255
    want = hist_pallas.grad_hist_pallas(bins, node, g, h, nnodes, nbins)
    tb = torch.from_numpy(bins.astype(np.uint8) if u8 else bins)
    args = [tb, *_t(node, g, h), nnodes, nbins]
    _close(hist_cuda.grad_hist_ref(*args), want, rtol=1e-5, atol=1e-5)
    # the K2 wrapper takes its plain version for CPU tensors
    _close(hist_cuda.grad_hist_cuda(*args), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,f,nbins,nnodes,drop,u8", KERNEL_CASES)
def test_grad_hist_fused_ref_matches_pallas(interpret_mode, b, f, nbins,
                                            nnodes, drop, u8):
    bins, node, g, h = _case(b, f, nbins, nnodes, seed=b + 2 * nnodes)
    if drop:
        node[1::4] = -1
    want = hist_pallas.grad_hist_pallas_fused(bins, node, g, h, nnodes,
                                              nbins)
    tb = torch.from_numpy(bins.astype(np.uint8) if u8 else bins)
    args = [tb, *_t(node, g, h), nnodes, nbins]
    _close(hist_cuda.grad_hist_fused_ref(*args), want, rtol=1e-5, atol=1e-5)
    _close(hist_cuda.grad_hist_fused_cuda(*args), want, rtol=1e-5,
           atol=1e-5)


@pytest.mark.parametrize("m,b,f,nbins,u8", [(16, 256, 3, 8, False),
                                            (32, 700, 2, 16, False),
                                            (16, 300, 4, 256, True)])
def test_hist_matmul_ref_matches_pallas(interpret_mode, m, b, f, nbins, u8):
    import jax.numpy as jnp

    rng = np.random.RandomState(m + b)
    w = rng.randn(m, b).astype(np.float32)
    w[m // 2:, :] = 0.0                                  # dead node rows
    bins = rng.randint(0, nbins, (b, f)).astype(np.int32)
    want = hist_pallas.hist_matmul_pallas(jnp.asarray(w).astype(jnp.bfloat16),
                                          bins, nbins)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tb = torch.from_numpy(bins.astype(np.uint8) if u8 else bins)
    got = hist_cuda.hist_matmul_ref(tw, tb, nbins)
    assert got.shape == (m, f * nbins)
    _close([got], [want], rtol=1e-5, atol=1e-5)
    _close([hist_cuda.hist_matmul_cuda(tw, tb, nbins)], [want], rtol=1e-5,
           atol=1e-5)


@pytest.mark.parametrize("nnodes", [32, 20])
def test_node_blocked_matches_pallas(interpret_mode, monkeypatch, nnodes):
    """Node counts beyond one accumulator: the reference's K2 sweeps node
    blocks (budgets shrunk so blocking triggers at test size), the port's
    takes every node at once (K3's kernel on the card, its plain version
    here); both packages' block plans agree and their (G, H) match."""
    limit = 2 * 8 * 3 * 16 * 4                           # 8-node blocks
    monkeypatch.setattr(hist_pallas, "_ACC_BYTES_LIMIT", limit)
    monkeypatch.setattr(hist_cuda, "_ACC_BYTES_LIMIT", limit)
    assert hist_cuda.hist_node_block(nnodes, 3, 16) == 8
    assert hist_pallas.hist_node_block(nnodes, 3, 16) == 8
    bins, node, g, h = _case(700, 3, 16, nnodes, seed=31 + nnodes)
    node[::6] = -1
    want = hist_pallas.grad_hist_pallas(bins, node, g, h, nnodes, 16)
    got = hist_cuda.grad_hist_cuda(*_t(bins, node, g, h), nnodes, 16)
    assert got[0].shape == (nnodes, 3, 16)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_grad_histogram_dispatches_kernel_methods(interpret_mode):
    bins, node, g, h = _case(400, 3, 16, 6, seed=9)
    for method, ref in (("pallas", hist_pallas.grad_hist_pallas),
                        ("pallas_fused", hist_pallas.grad_hist_pallas_fused)):
        want = ref(bins, node, g, h, 6, 16)
        got = port_hist.grad_histogram(*_t(bins, node, g, h), 6, 16,
                                       method=method, device="cpu")
        _close(got, want, rtol=1e-5, atol=1e-5)


# -- K3's listed mode on CPU tensors: bitwise the dense call ------------------
LISTED_CASES = [
    # b, f, nbins, built nodes, uint8 bins, column window (offset, count)
    (700, 3, 16, 1, False, (0, None)),
    (1000, 5, 256, 8, True, (0, None)),
    (777, 6, 32, 13, False, (2, 3)),
    (300, 4, 16, 64, True, (1, 2)),
]


@pytest.mark.parametrize("b,f,nbins,built,u8,window", LISTED_CASES)
def test_listed_histogram_is_bitwise_the_dense_one(b, f, nbins, built, u8,
                                                   window):
    """A level below the root (most ids -1 or past the built nodes): K3's
    listed call and ``grad_histogram(listed=True)`` with both kernel
    methods give the dense call's bits, since the stable grouping keeps
    each (node, feature, bin)'s rows in row order; no kernel runs."""
    rng = np.random.RandomState(b + built)
    bins, _, g, h = _case(b, f, nbins, built, seed=b)
    ids = rng.randint(-1, 3 * built, b).astype(np.int32)
    tb = torch.from_numpy(bins.astype(np.uint8) if u8 else bins)
    tn, tg, th = _t(ids, g, h)
    hist_cuda.reset_launches()
    rows, offsets = hist_cuda.row_partition(tn, built)
    dense = hist_cuda.grad_hist_fused_cuda(tb, tn, tg, th, built, nbins,
                                           *window)
    listed = hist_cuda.grad_hist_fused_cuda(tb, tn, tg, th, built, nbins,
                                            *window, rows=rows,
                                            offsets=offsets)
    k2 = hist_cuda.grad_hist_cuda(tb, tn, tg, th, built, nbins, *window,
                                  rows=rows, offsets=offsets)
    for a, c, d in zip(dense, listed, k2):
        assert torch.equal(a, c) and torch.equal(a, d)
    for method in ("pallas", "pallas_fused"):
        got = port_hist.grad_histogram(tb, tn, tg, th, built, nbins,
                                       method=method, device="cpu",
                                       listed=True)
        want = port_hist.grad_histogram(tb, tn, tg, th, built, nbins,
                                        method=method, device="cpu")
        for a, c in zip(got, want):
            assert torch.equal(a, c)
    assert set(hist_cuda.LAUNCHES.values()) == {0}
