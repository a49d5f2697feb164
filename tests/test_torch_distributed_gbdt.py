"""Distributed hist-GBDT in the port vs the JAX package.

One launch of four port workers through the JAX package's tracker, on the
CPU (gloo, ``device="cpu"``, the kernels' plain versions).  Each worker
takes its rows of one seeded dataset and fits under a mesh:

- ``model``: a 2 x 2 data x model mesh, ``make_bins(comm=collective)``,
  then ``fit_binned`` with ``model_axis="model"`` and ``"pallas"`` (K4 on
  every level);
- ``empty_shard``: the same mesh and boundaries with every row on data
  shard 0, so the ranks of data shard 1 join every collective with none;
- ``data``: pure data parallelism, a 4-rank ``data`` mesh and
  ``"scatter"``.

On each, ``append_rounds`` (``boost_round`` round by round) must grow the
ensemble ``fit_binned`` grew, bitwise.

Every rank must hold the same boundaries and a bitwise identical ensemble.
The trees must equal the JAX fits on the same global rows with the same
boundaries (``GBDT(model_axis="model")`` under a 4 x 2 CPU mesh, Pallas in
interpret mode, for the first two; the single-process scatter fit for the
third): ``split_feat`` equal, ``split_bin`` equal where a node splits,
leaf values and margins to rtol 1e-4 (f32 sums in another order).
"""

import numpy as np
import pytest

from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.ops import hist_pallas

B, F = 1024, 8
PARAM = dict(num_boost_round=3, max_depth=3, num_bins=16)
FIELDS = ("split_feat", "split_bin", "leaf_value", "default_left",
          "split_gain", "split_cover")


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(B, F).astype(np.float32)
    w = rng.randn(F).astype(np.float32)
    y = ((x @ w + 0.3 * rng.randn(B)) > 0).astype(np.float32)
    return x, y


WORKER = r"""
import os
import numpy as np
import torch
from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.ops import hist_cuda
from dmlc_core_tpu_torch.parallel.mesh import make_mesh, row_range

B, F = %(B)d, %(F)d
PARAM = %(PARAM)r
FIELDS = %(FIELDS)r
rng = np.random.RandomState(0)
x = rng.randn(B, F).astype(np.float32)
w = rng.randn(F).astype(np.float32)
y = ((x @ w + 0.3 * rng.randn(B)) > 0).astype(np.float32)

# the tracker's env names rank, world and coordinator; the store's port
# is the test's own (see store_port in test_torch_collective.py)
collective.init({"device": "cpu", "timeout": 60,
                 "DMLC_COORDINATOR_PORT": os.environ["STORE_PORT"]})
rank = collective.get_rank()
sharded_calls = []
plain = hist_cuda.grad_hist_sharded_ref


def counting(*args, **kwargs):
    sharded_calls.append(1)
    return plain(*args, **kwargs)


hist_cuda.grad_hist_sharded_ref = counting
out = {}


def fit(tag, mesh, lo, hi, model_axis, method, boundaries=None):
    model = GBDT(GBDTParam(hist_method=method, **PARAM), F,
                 model_axis=model_axis, device="cpu")
    if boundaries is None:
        model.make_bins(x[lo:hi], comm=collective)
    else:
        model.set_boundaries(boundaries)
    bins = model.bin_features(x[lo:hi])
    del sharded_calls[:]
    with mesh:
        ens, margin = model.fit_binned(bins, y[lo:hi])
        calls = len(sharded_calls)
        # the streaming entry points grow the same trees, round by round
        rounds = PARAM["num_boost_round"]
        more, more_margin = model.append_rounds(None, bins, y[lo:hi],
                                                num_rounds=rounds)
    assert all(torch.equal(a, b) for a, b in zip(ens, more)), tag
    assert torch.equal(margin, more_margin), tag
    out[tag + "_k4_calls"] = calls
    for name in FIELDS:
        out[tag + "_" + name] = getattr(ens, name).numpy()
    out[tag + "_margin"] = margin.numpy()
    out[tag + "_rows"] = np.array([lo, hi])
    out[tag + "_boundaries"] = model.boundaries
    return model.boundaries


grid = make_mesh({"data": 2, "model": 2})
lo, hi = row_range(grid, B)
bounds = fit("model", grid, lo, hi, "model", "pallas")
d = grid.coord("data")
fit("empty_shard", grid, 0, B if d == 0 else 0, "model", "pallas", bounds)
line = make_mesh()
lo, hi = row_range(line, B)
fit("data", line, lo, hi, None, "scatter")
assert set(hist_cuda.LAUNCHES.values()) == {0}, hist_cuda.LAUNCHES
np.savez(os.path.join(os.environ["RESULT_DIR"], "rank%%d.npz" %% rank), **out)
collective.finalize()
""" % dict(B=B, F=F, PARAM=PARAM, FIELDS=FIELDS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tests.conftest import run_tracker_workers
    from tests.test_torch_collective import store_port

    tmp = tmp_path_factory.mktemp("distributed_gbdt")
    proc = run_tracker_workers(tmp, WORKER, 4, timeout=120,
                               env_extra={"OMP_NUM_THREADS": "1",
                                          "STORE_PORT": str(store_port())})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _jax_fit(method, boundaries, model_axis=None):
    x, y = _data()
    model = JaxGBDT(JaxParam(hist_method=method, **PARAM), F,
                    model_axis=model_axis)
    model.set_boundaries(boundaries)
    bins = np.asarray(model.bin_features(x))
    if model_axis is None:
        ens, margin = model.fit_binned(bins, y)
    else:
        import jax
        from dmlc_core_tpu.parallel.mesh import make_mesh

        hist_pallas._INTERPRET = True
        for probe in (hist_pallas.pallas_supported,
                      hist_pallas.pallas_fused_supported,
                      hist_pallas.pallas_i8_supported):
            probe.cache_clear()
        try:
            assert hist_pallas.pallas_supported()
            with make_mesh({"data": 4, "model": 2},
                           devices=jax.devices()[:8]):
                assert model._method(batch=B) == "pallas"
                ens, margin = model.fit_binned(bins, y)
                ens = [np.asarray(a) for a in ens]
                margin = np.asarray(margin)
        finally:
            hist_pallas._INTERPRET = False
            for probe in (hist_pallas.pallas_supported,
                          hist_pallas.pallas_fused_supported,
                          hist_pallas.pallas_i8_supported):
                probe.cache_clear()
    return dict(zip(FIELDS, (np.asarray(a) for a in ens))), np.asarray(margin)


CASES = {
    # tag: (JAX method, JAX model_axis, K4 calls per rank)
    "model": ("pallas", "model", 9),
    "empty_shard": ("pallas", "model", 9),
    "data": ("scatter", None, 0),
}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_distributed_fit_matches_jax(ranks, tag):
    method, model_axis, k4_calls = CASES[tag]
    r0 = ranks[0]
    for r in ranks:
        # one ensemble and one set of boundaries on every rank, bitwise
        np.testing.assert_array_equal(r[tag + "_boundaries"],
                                      r0[tag + "_boundaries"])
        for name in FIELDS:
            np.testing.assert_array_equal(r[tag + "_" + name],
                                          r0[tag + "_" + name], err_msg=name)
        # every level of every tree went through K4's plain version
        assert int(r[tag + "_k4_calls"]) == k4_calls
    want, want_margin = _jax_fit(method, r0[tag + "_boundaries"], model_axis)
    np.testing.assert_array_equal(r0[tag + "_split_feat"],
                                  want["split_feat"])
    split = want["split_feat"] >= 0
    np.testing.assert_array_equal(r0[tag + "_split_bin"][split],
                                  want["split_bin"][split])
    np.testing.assert_array_equal(r0[tag + "_default_left"],
                                  want["default_left"])
    for name in ("leaf_value", "split_cover"):
        np.testing.assert_allclose(r0[tag + "_" + name], want[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # margins stay on the rank that owns the rows
    for r in ranks:
        lo, hi = r[tag + "_rows"]
        np.testing.assert_allclose(r[tag + "_margin"], want_margin[lo:hi],
                                   rtol=1e-4, atol=1e-4)
