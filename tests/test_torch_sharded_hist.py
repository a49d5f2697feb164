"""The port's model-sharded histogram (K4) and distributed binning vs JAX.

- ``sharded_hist_plan`` gives a plan exactly where the JAX gate does, over
  a grid of shapes, the JAX side under a CPU mesh of the 8 host devices
  of ``tests/conftest.py``;
- ``distributed_quantile_boundaries`` is bitwise equal to JAX's, with a
  fake ``comm`` whose ``allgather`` stacks every simulated rank's
  contribution;
- K4's rank pieces: on every ``(d, m)`` of a 4 x 2 layout the port's
  ``grad_histogram(model_axis="model")`` (its K4 wrapper taking the plain
  version on the CPU, collectives stubbed out) gives the rank's window of
  its rows; summed over ``d`` and joined over ``m`` in numpy they match the
  JAX sharded Pallas kernel in interpret mode to rtol/atol 1e-5 (the same
  bf16 inputs, f32 sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from dmlc_core_tpu.ops import hist_pallas
from dmlc_core_tpu.ops import histogram as jax_hist
from dmlc_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.ops import histogram as port_hist
from dmlc_core_tpu_torch.parallel.mesh import Mesh, row_range


@pytest.fixture
def interpret_mode():
    def clear():
        for probe in (hist_pallas.pallas_supported,
                      hist_pallas.pallas_fused_supported,
                      hist_pallas.pallas_i8_supported):
            probe.cache_clear()

    hist_pallas._INTERPRET = True
    clear()
    # probe outside any mesh or trace: a probe first run while tracing
    # under a mesh fails, and the reference would then leave the kernel
    assert hist_pallas.pallas_supported()
    assert hist_pallas.pallas_fused_supported()
    yield
    hist_pallas._INTERPRET = False
    clear()


def _jax_mesh(data, model):
    return jax_make_mesh({"data": data, "model": model},
                         devices=jax.devices()[:data * model])


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_sharded_hist_plan_matches_jax(mp):
    jmesh = _jax_mesh(8 // mp, mp)
    pmesh = Mesh({"data": 8 // mp, "model": mp})
    for F in (7, 8, 28, 512):
        for n in (1, 32, 1024):
            for nb in (16, 256, 1024):
                want = hist_pallas.sharded_hist_plan("model", F, n, nb,
                                                     mesh=jmesh) is not None
                got = hist_cuda.sharded_hist_plan("model", F, n, nb,
                                                  mesh=pmesh) is not None
                assert got == want, (F, mp, n, nb)
    # no model axis, no such axis in the mesh, or no mesh at all: no plan
    assert hist_cuda.sharded_hist_plan(None, 8, 4, 16, mesh=pmesh) is None
    assert hist_cuda.sharded_hist_plan("tensor", 8, 4, 16, mesh=pmesh) is None
    assert hist_cuda.sharded_hist_plan("model", 8, 4, 16) is None
    with pmesh:
        assert hist_cuda.sharded_hist_plan("model", 8, 4, 16) is pmesh


class _Recorded(Exception):
    pass


def _as_ranks(fn, shards, counts, num_bins):
    """Run ``fn(sample, num_bins, comm=..., count=...)`` once per shard as
    if each were a rank, with an ``allgather`` that stacks what every
    rank sends.  A first pass records each rank's two contributions."""
    sent = []
    for shard, count in zip(shards, counts):
        calls = []

        class Record:
            @staticmethod
            def allgather(a):
                calls.append(np.asarray(a))
                if len(calls) == 2:
                    raise _Recorded
                return np.asarray(a)[None]

        with pytest.raises(_Recorded):
            fn(shard, num_bins, comm=Record(), count=count)
        sent.append(calls)

    class Stack:
        def __init__(self):
            self.round = 0

        def allgather(self, a):
            out = np.stack([calls[self.round] for calls in sent])
            self.round += 1
            return out

    return [fn(shard, num_bins, comm=Stack(), count=count)
            for shard, count in zip(shards, counts)]


@pytest.mark.parametrize("scaled", [False, True])
def test_distributed_quantile_boundaries_bitwise(scaled):
    rng = np.random.RandomState(21)
    shards = [rng.randn(n, 4).astype(np.float32) * (i + 1) + i
              for i, n in enumerate((300, 120, 200))]
    shards[1][::5, 2] = np.nan
    counts = (3000, 120, 50_000) if scaled else (None, None, None)
    for nb in (16, 64):
        want = _as_ranks(jax_hist.distributed_quantile_boundaries, shards,
                         counts, nb)
        got = _as_ranks(port_hist.distributed_quantile_boundaries, shards,
                        counts, nb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, got[0])   # same on every rank
    # without a comm both are the plain quantiles
    np.testing.assert_array_equal(
        port_hist.distributed_quantile_boundaries(shards[0], 16),
        jax_hist.distributed_quantile_boundaries(shards[0], 16))


def _case(b, f, nbins, nnodes, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nbins, (b, f)).astype(np.int32)
    node = rng.randint(0, nnodes, b).astype(np.int32)
    node[::7] = -1                                        # rows that drop
    g = rng.randn(b).astype(np.float32)
    h = rng.rand(b).astype(np.float32)
    return bins, node, g, h


SHARDED_CASES = {
    # F, nbins, num_nodes, _ACC_BYTES_LIMIT (None: unchanged)
    "plain": (8, 16, 6, None),
    "node_blocked": (8, 16, 20, 2 * 8 * 4 * 16 * 4),    # 8-node blocks
    "uneven_features": (7, 8, 4, None),                 # 7 % 2: onehot
}


@pytest.mark.parametrize("method", ["pallas", "pallas_fused"])
@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_rank_pieces_match_jax_sharded(interpret_mode, monkeypatch, case,
                                       method):
    F, nb, n, limit = SHARDED_CASES[case]
    if limit is not None:
        monkeypatch.setattr(hist_pallas, "_ACC_BYTES_LIMIT", limit)
        monkeypatch.setattr(hist_cuda, "_ACC_BYTES_LIMIT", limit)
    bins, node, g, h = _case(512, F, nb, n, seed=len(case) + n)
    dp, mp = 4, 2

    jax_calls = []
    jax_sharded = hist_pallas.grad_hist_pallas_sharded

    def jax_spy(*args, **kwargs):
        jax_calls.append(kwargs.get("fused"))
        return jax_sharded(*args, **kwargs)

    monkeypatch.setattr(hist_pallas, "grad_hist_pallas_sharded", jax_spy)
    with _jax_mesh(dp, mp):
        want = jax.jit(lambda *a: jax_hist.grad_histogram(
            *a, n, nb, model_axis="model", method=method))(bins, node, g, h)
        want = [np.asarray(w) for w in want]

    # each rank's piece: the collectives that would join the pieces are
    # stubbed out here (the multi-process tests run them)
    port_calls = []
    port_sharded = hist_cuda.grad_hist_sharded_cuda

    def port_spy(*args, **kwargs):
        port_calls.append(args[4:6])                  # num_nodes, num_bins
        return port_sharded(*args, **kwargs)

    monkeypatch.setattr(hist_cuda, "grad_hist_sharded_cuda", port_spy)
    monkeypatch.setattr(hist_cuda, "_shard_collectives",
                        lambda G, H, *rest: (G, H))
    monkeypatch.setattr(port_hist, "data_allreduce", lambda *t: t)
    pieces = {}
    for d in range(dp):
        for m in range(mp):
            mesh = Mesh({"data": dp, "model": mp}, rank=d * mp + m)
            lo, hi = row_range(mesh, len(bins))
            rows = [torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
                    for a in (bins, node, g, h)]
            with mesh:
                pieces[d, m] = [t.numpy() for t in port_hist.grad_histogram(
                    *rows, n, nb, model_axis="model", method=method,
                    device="cpu")]

    # K4 on every rank where the reference takes its sharded kernel (the
    # port runs one kernel for both methods, so there is no fused flag)
    assert port_calls == [(n, nb)] * (dp * mp if jax_calls else 0)
    if case == "uneven_features":
        assert jax_calls == []                           # both take onehot
        for m in range(1, mp):
            for d in range(dp):
                for a, b in zip(pieces[d, m], pieces[d, 0]):
                    np.testing.assert_array_equal(a, b)
        got = [sum(pieces[d, 0][i] for d in range(dp)) for i in (0, 1)]
    else:
        assert jax_calls == [method == "pallas_fused" and case == "plain"]
        got = [np.concatenate([sum(pieces[d, m][i] for d in range(dp))
                               for m in range(mp)], axis=1) for i in (0, 1)]
    for a, b in zip(got, want):
        assert a.shape == (n, F, nb)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_window_wrappers_read_the_columns_in_place():
    """On the CPU the windowed K1/K2/K3 wrappers equal their plain versions
    on a copy of the columns; a window outside the array raises."""
    bins, node, g, h = _case(300, 6, 16, 5, seed=3)
    tb, tn, tg, th = [torch.from_numpy(a) for a in (bins, node, g, h)]
    want = hist_cuda.grad_hist_ref(tb[:, 2:5].contiguous(), tn, tg, th, 5, 16)
    for fn in (hist_cuda.grad_hist_cuda, hist_cuda.grad_hist_fused_cuda):
        for a, b in zip(fn(tb, tn, tg, th, 5, 16, 2, 3), want):
            assert torch.equal(a, b)
    w = torch.from_numpy(np.random.RandomState(4).randn(16, 300)).bfloat16()
    assert torch.equal(hist_cuda.hist_matmul_cuda(w, tb, 16, 4),
                       hist_cuda.hist_matmul_ref(w, tb[:, 4:].contiguous(),
                                                 16))
    with pytest.raises(RuntimeError, match="outside 6 features"):
        hist_cuda.grad_hist_cuda(tb, tn, tg, th, 5, 16, 4, 3)
