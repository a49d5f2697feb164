"""The port's segment sum against ``jax.ops.segment_sum``.

``hist_cuda.segment_sum`` backs the ``"scatter"`` histogram, the kernels'
plain versions and the scatter-path leaf sums.  On the CPU it adds each
column with ``index_add_``; on the card it takes ``hist_cuda._sorted_sums``
(a stable sort of the ids, then one ordered sum per segment, no float
atomics).  Both forms run here on CPU tensors, on the same inputs made from
a seed with numpy as JAX gets them.  Tolerance rtol 1e-5, atol 1e-5: f32
sums of the same values in another order.

On CPU tensors the sorted form runs the CPU's ``segment_reduce``, not the
card's, so these tests hold its logic (sort, segment starts, spill segment)
and not the card's summation order.  The card's form is held by the
``cuda``-marked test below and by ``chip_smoke.py``, whose kernel phase
calls the plain versions twice bitwise and whose GBDT phase fits
``"scatter"`` twice bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.ops import hist_cuda

F, NB = 28, 256                   # the main path's width: 7,168 segments


def _case(name, rng):
    """(ids [N] int32, num_segments) of one named case."""
    if name == "out_of_range":          # -1, -3 and ids >= num_segments
        return rng.randint(-3, 45, 600).astype(np.int32), 40
    if name == "empty_segments":        # odd segments get no row
        return 2 * rng.randint(0, 25, 500).astype(np.int32), 50
    if name == "hot_segment":           # one segment holds 90% of the rows
        ids = rng.randint(0, 30, 2000).astype(np.int32)
        ids[rng.rand(2000) < 0.9] = 7
        return ids, 30
    if name == "one_segment":
        return rng.randint(-1, 2, 300).astype(np.int32), 1
    if name == "no_rows":               # a data shard that holds no row
        return np.zeros(0, np.int32), 5
    # the n = 1 level of the main path: node 0 or -1, 28 x 256 bins
    rows = 3000
    node = rng.randint(-1, 1, rows)
    bins = rng.randint(0, NB, (rows, F))
    ids = np.where(node[:, None] >= 0,
                   node[:, None] * F * NB + np.arange(F) * NB + bins, -1)
    return ids.reshape(-1).astype(np.int32), F * NB


CASES = ["out_of_range", "empty_segments", "hot_segment", "one_segment",
         "no_rows", "7168_segments"]


def _sorted_form(values, ids, num_segments):
    """The card's form of ``segment_sum``, run on CPU tensors."""
    ids = ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    cols = values.t() if values.dim() == 2 else values[None]
    sums = hist_cuda._sorted_sums(cols, ids, num_segments + 1)
    out = torch.stack(sums, dim=1)[:num_segments]
    return out.reshape((num_segments,) + tuple(values.shape[1:]))


@pytest.mark.parametrize("form", ["segment_sum", "sorted"])
@pytest.mark.parametrize("width", [None, 2])
@pytest.mark.parametrize("case", CASES)
def test_segment_sum_matches_jax(case, width, form):
    rng = np.random.RandomState(CASES.index(case))
    ids, nseg = _case(case, rng)
    shape = ids.shape if width is None else ids.shape + (width,)
    values = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(values, ids, num_segments=nseg))
    fn = hist_cuda.segment_sum if form == "segment_sum" else _sorted_form
    got = fn(torch.from_numpy(values), torch.from_numpy(ids), nseg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_sum_takes_cpu_or_cuda_tensors():
    """Tensors on any other device raise: there is no third route."""
    values = torch.zeros(4, device="meta")
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        hist_cuda.segment_sum(values, ids, 3)


@pytest.mark.cuda
def test_segment_sum_bitwise_on_card():
    """On the card: the n = 1 level's hot bins (every live row in one node,
    7,168 segments) summed twice give the same bits, and agree with the
    CPU's ``index_add_`` (run with ``pytest -m cuda`` on a GPU machine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(5)
    rows = 200_000
    bins = torch.from_numpy(rng.randint(0, NB, (rows, F)).astype(np.uint8))
    node = torch.from_numpy(rng.randint(-1, 1, rows).astype(np.int32))
    g = torch.from_numpy(rng.randn(rows).astype(np.float32))
    h = torch.from_numpy(rng.rand(rows).astype(np.float32))
    want = hist_cuda.scatter_sums(bins, node, g, h, 1, NB)
    dev = torch.device("cuda")
    args = [t.to(dev) for t in (bins, node, g, h)] + [1, NB]
    first = hist_cuda.scatter_sums(*args)
    again = hist_cuda.scatter_sums(*args)
    for a, b, c in zip(first, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-5, atol=1e-4)
    leaf = torch.from_numpy(rng.randint(0, 64, rows))
    gh = torch.stack([g, h], dim=1)
    sums = [hist_cuda.segment_sum(gh.to(dev), leaf.to(dev), 64)
            for _ in range(2)]
    assert torch.equal(sums[0], sums[1])
    torch.testing.assert_close(sums[0].cpu(),
                               hist_cuda.segment_sum(gh, leaf, 64),
                               rtol=1e-5, atol=1e-3)
