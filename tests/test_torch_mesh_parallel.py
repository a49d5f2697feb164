"""The port's hybrid mesh, shardings and mesh primitives against the JAX
package's.

In this process: the hybrid layout (``dcn`` axes outermost, ranks
row-major) against the JAX device array of ``make_hybrid_mesh`` on the
8-device CPU mesh, rank ``i`` in the place of device ``i``.  One launch of
4 port ranks (the port's launcher, gloo, ``device="cpu"``) then saves, per
rank: the hybrid mesh's coordinates, ``data_sharding`` and
``replicated_sharding`` blocks, a psum and an all-gather over a tuple of
axes, ``ring_allreduce`` and ``psum`` of the same shards,
``allreduce_bandwidth_gbps``, the differentiable ``ppermute`` and
``all_to_all`` with the gradients of a fixed cotangent, and one GBDT
round (K4's plain version) on the flat 2 x 2 data x model mesh and on the
hybrid 2 x 1 x 2 dcn_data x ici_data x model mesh.  The test holds them to
the JAX functions on a 4-device sub-mesh: blocks and coordinates equal,
the ring within rtol 1e-5 (it is also bitwise: the same segments are
added in the same order), the primitives and their vjp bitwise, and each
round's margin within 1e-5 of the JAX ``boost_round`` on the same mesh
(and the hybrid round's of the flat round's).
"""

import numpy as np
import pytest

import jax
import jax.lax as lax
from jax.sharding import NamedSharding, PartitionSpec as P

from dmlc_core_tpu.collective.mesh_collectives import (
    ring_allreduce as jax_ring_allreduce)
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.parallel.compat import get_shard_map
from dmlc_core_tpu.parallel.mesh import data_sharding as jax_data_sharding
from dmlc_core_tpu.parallel.mesh import make_hybrid_mesh as jax_hybrid
from dmlc_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmlc_core_tpu.parallel.mesh import (
    replicated_sharding as jax_replicated)
from dmlc_core_tpu_torch.parallel.mesh import (Mesh, data_sharding,
                                               make_hybrid_mesh)
from dmlc_core_tpu_torch.utils.logging import Error
from tests.test_torch_tracker import run_port_workers

N = 4
X = np.arange(48, dtype=np.float32).reshape(16, 3)

WORKER = r'''
import os

import numpy as np
import torch

from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.collective.mesh_collectives import (
    MeshCollective, all_to_all, allreduce_bandwidth_gbps, ppermute,
    ring_allreduce)
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.parallel.mesh import (data_sharding, make_groups,
                                               make_hybrid_mesh, make_mesh,
                                               replicated_sharding)
from dmlc_core_tpu_torch.utils.logging import Error

collective.init({"device": "cpu", "timeout": 60})
r = collective.get_rank()
out = {}
x = np.arange(48, dtype=np.float32).reshape(16, 3)
hm = make_hybrid_mesh({"ici_data": 1, "model": 2}, {"dcn_data": 2})
flat = make_mesh({"data": 2, "model": 2})
ring = make_mesh({"x": 4})
out["hybrid_coord"] = np.array([hm.coord(a) for a in hm.axis_names])
out["shard_rows"] = data_sharding(hm, axis=("dcn_data", "ici_data"),
                                  ndim=2).shard(x)
out["shard_model"] = data_sharding(hm, axis="model", ndim=2).shard(x)
out["shard_flat"] = data_sharding(flat, ndim=2).shard(x)
out["shard_repl"] = replicated_sharding(hm).shard(x)
# make_mesh makes the groups of single axes only: a tuple needs make_groups
try:
    MeshCollective(flat, ("data", "model"))
    out["tuple_refused"] = np.array(False)
except Error:
    out["tuple_refused"] = np.array(True)
make_groups(flat, ("data", "model"))
both = MeshCollective(flat, ("data", "model"))
out["psum_tuple"] = both.psum(torch.full((3,), float(r + 1))).numpy()
out["gather_tuple"] = both.allgather(torch.tensor([float(r)])).numpy()
out["gather_rows"] = MeshCollective(hm, ("dcn_data", "ici_data")).allgather(
    torch.tensor([float(r)])).numpy()

rng = np.random.RandomState(7)
xr = rng.randn(4 * 8, 3).astype(np.float32)
mine = torch.from_numpy(xr[8 * r:8 * (r + 1)].copy())
coll = MeshCollective(ring, "x")
out["ring"] = ring_allreduce(ring, "x", mine).numpy()
out["psum"] = coll.psum(mine).numpy()
out["gbps"] = np.array(allreduce_bandwidth_gbps(ring, "x", nbytes=1 << 16,
                                                iters=3, device="cpu"))

xp = rng.randn(8, 5).astype(np.float32)
cp = rng.randn(8, 5).astype(np.float32)
blk = torch.from_numpy(xp[2 * r:2 * (r + 1)].copy()).requires_grad_(True)
y = ppermute(blk, coll, 1)
(y * torch.from_numpy(cp[2 * r:2 * (r + 1)].copy())).sum().backward()
out["pp_y"], out["pp_dx"] = y.detach().numpy(), blk.grad.numpy()

xa = rng.randn(2, 8, 4, 3).astype(np.float32)
ca = rng.randn(2, 8, 4, 3).astype(np.float32)
blk = torch.from_numpy(xa[:, 2 * r:2 * (r + 1)].copy()).requires_grad_(True)
y = all_to_all(blk, coll, 2, 1)                # [2, 8, 1, 3]
(y * torch.from_numpy(ca[:, :, r:r + 1].copy())).sum().backward()
out["a2a_y"], out["a2a_dx"] = y.detach().numpy(), blk.grad.numpy()

B, F = 32, 8
g = np.random.RandomState(0)
xg = g.randn(B, F).astype(np.float32)
yg = (xg[:, 0] > 0).astype(np.float32)
param = GBDTParam(num_boost_round=1, max_depth=3, num_bins=16,
                  hist_method="pallas")
probe = GBDT(param, F, model_axis="model", device="cpu")
probe.make_bins(xg)
out["gbdt_boundaries"] = np.asarray(probe.boundaries)
bins = probe.bin_features(xg)
for tag, sharding in (("flat", data_sharding(flat, ndim=1)),
                      ("hybrid", data_sharding(
                          hm, axis=("dcn_data", "ici_data"), ndim=1))):
    model = GBDT(param, F, model_axis="model", device="cpu")
    model.set_boundaries(probe.boundaries)
    with sharding:
        label = torch.from_numpy(sharding.shard(yg))
        margin, _ = model.boost_round(torch.zeros_like(label),
                                      sharding.shard(bins), label,
                                      torch.ones_like(label))
    out["gbdt_" + tag] = margin.numpy()
np.savez(os.path.join(os.environ["RESULT_DIR"], f"mesh{r}.npz"), **out)
collective.finalize()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    proc = run_port_workers(tmp, WORKER, N, timeout=120,
                            env_extra={"DMLC_COLLECTIVE_TIMEOUT": "60"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [np.load(tmp / f"mesh{r}.npz") for r in range(N)]


def _device_coords(jmesh):
    """{device id: its coordinates} of a JAX mesh."""
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    return {int(ids[idx]): idx for idx in np.ndindex(ids.shape)}


@pytest.mark.parametrize("ici,dcn", [
    ({"ici_data": 1, "model": 2}, {"dcn_data": 2}),
    ({"ici_data": 2, "model": 2}, {"dcn_data": 2}),
    ({"model": 4}, {"data": 2}),
])
def test_hybrid_layout_matches_jax_devices(ici, dcn):
    jmesh = jax_hybrid(ici, dcn)
    shape = dict(zip(jmesh.axis_names, jmesh.devices.shape))
    want = _device_coords(jmesh)
    for rank in range(int(np.prod(list(shape.values())))):
        m = Mesh(shape, rank)
        assert m.axis_names == jmesh.axis_names
        assert tuple(m.coord(a) for a in m.axis_names) == want[rank]


def test_hybrid_mesh_covers_the_job():
    with pytest.raises(Error, match="needs 4 devices"):
        make_hybrid_mesh({"ici_data": 1, "model": 2}, {"dcn_data": 2})


def test_hybrid_coords_of_the_ranks(ranks):
    want = _device_coords(jax_hybrid({"ici_data": 1, "model": 2},
                                     {"dcn_data": 2}))
    for r, got in enumerate(ranks):
        assert tuple(got["hybrid_coord"]) == want[r]


def _jax_blocks(sharding):
    arr = jax.device_put(X, sharding)
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


@pytest.mark.parametrize("name", ["shard_rows", "shard_model", "shard_flat",
                                  "shard_repl"])
def test_sharding_blocks_match_jax(ranks, name):
    hm = jax_hybrid({"ici_data": 1, "model": 2}, {"dcn_data": 2})
    flat = jax_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:N])
    sharding = {
        "shard_rows": jax_data_sharding(hm, axis=("dcn_data", "ici_data"),
                                        ndim=2),
        "shard_model": jax_data_sharding(hm, axis="model", ndim=2),
        "shard_flat": jax_data_sharding(flat, ndim=2),
        "shard_repl": jax_replicated(hm)}[name]
    want = _jax_blocks(sharding)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[name], want[r])


def test_sharding_checks_rows_divide():
    with pytest.raises(Error, match="do not split evenly"):
        data_sharding(Mesh({"data": 3}, rank=0), ndim=2).shard(X)


def test_collectives_over_a_tuple_of_axes(ranks):
    for got in ranks:
        assert bool(got["tuple_refused"])
        np.testing.assert_array_equal(got["psum_tuple"], np.full(3, 10.0))
        np.testing.assert_array_equal(got["gather_tuple"], np.arange(4.0))
    # the rows of the hybrid mesh: ranks (0, 1) hold row block 0 and
    # (2, 3) block 1, so each line gathers the ranks of its model column
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gather_rows"], [r % 2, r % 2 + 2])


def test_ring_allreduce_matches_jax_ring(ranks):
    rng = np.random.RandomState(7)
    xr = rng.randn(4 * 8, 3).astype(np.float32)
    jmesh = jax_make_mesh({"x": N}, devices=jax.devices()[:N])
    want = np.asarray(jax_ring_allreduce(
        jmesh, "x", jax.device_put(xr, NamedSharding(jmesh, P("x")))))
    for r, got in enumerate(ranks):
        block = want[8 * r:8 * (r + 1)]
        np.testing.assert_allclose(got["ring"], block, rtol=1e-5, atol=0)
        # bitwise: the same segments added in the same order
        np.testing.assert_array_equal(got["ring"], block)
        np.testing.assert_allclose(got["ring"], got["psum"], rtol=1e-5,
                                   atol=1e-6)


def test_allreduce_bandwidth_is_positive(ranks):
    for got in ranks:
        assert float(got["gbps"]) > 0


def _jax_vjp(fn, x, ct, in_spec, out_spec):
    jmesh = jax_make_mesh({"x": N}, devices=jax.devices()[:N])
    f = jax.jit(get_shard_map()(fn, mesh=jmesh, in_specs=in_spec,
                                out_specs=out_spec))
    y, vjp = jax.vjp(f, x)
    return np.asarray(y), np.asarray(vjp(ct)[0])


def test_ppermute_and_its_gradient_match_jax_vjp(ranks):
    rng = np.random.RandomState(7)
    rng.randn(4 * 8, 3)
    xp = rng.randn(8, 5).astype(np.float32)
    cp = rng.randn(8, 5).astype(np.float32)
    perm = [(i, (i + 1) % N) for i in range(N)]
    y, dx = _jax_vjp(lambda a: lax.ppermute(a, "x", perm), xp, cp,
                     P("x"), P("x"))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["pp_y"], y[2 * r:2 * (r + 1)])
        np.testing.assert_array_equal(got["pp_dx"], dx[2 * r:2 * (r + 1)])


def test_all_to_all_and_its_gradient_match_jax_vjp(ranks):
    rng = np.random.RandomState(7)
    rng.randn(4 * 8, 3)
    rng.randn(8, 5)
    rng.randn(8, 5)
    xa = rng.randn(2, 8, 4, 3).astype(np.float32)
    ca = rng.randn(2, 8, 4, 3).astype(np.float32)
    y, dx = _jax_vjp(
        lambda a: lax.all_to_all(a, "x", split_axis=2, concat_axis=1,
                                 tiled=True),
        xa, ca, P(None, "x", None, None), P(None, None, "x", None))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["a2a_y"], y[:, :, r:r + 1])
        np.testing.assert_array_equal(got["a2a_dx"],
                                      dx[:, 2 * r:2 * (r + 1)])


def test_hybrid_gbdt_round_equals_the_flat_round(ranks):
    for got in ranks:
        assert np.isfinite(got["gbdt_flat"]).all()
        np.testing.assert_allclose(got["gbdt_hybrid"], got["gbdt_flat"],
                                   rtol=0, atol=1e-5)
    # the round moved the margins, and the ranks of a model line agree
    assert np.abs(ranks[0]["gbdt_flat"]).max() > 0
    np.testing.assert_array_equal(ranks[0]["gbdt_flat"],
                                  ranks[1]["gbdt_flat"])


def _jax_round(jmesh, axis, boundaries):
    """The JAX dryrun's GBDT round on ``jmesh``, rows over ``axis``."""
    g = np.random.RandomState(0)
    xg = g.randn(32, 8).astype(np.float32)
    yg = (xg[:, 0] > 0).astype(np.float32)
    model = JaxGBDT(JaxParam(num_boost_round=1, max_depth=3, num_bins=16), 8,
                    model_axis="model")
    model.set_boundaries(boundaries)
    rows1 = jax_data_sharding(jmesh, axis=axis, ndim=1)
    with jmesh:
        bins = jax.device_put(model.bin_features(xg),
                              jax_data_sharding(jmesh, axis=axis, ndim=2))
        margin, _ = model.boost_round(
            jax.device_put(np.zeros(32, np.float32), rows1),
            bins, jax.device_put(yg, rows1),
            jax.device_put(np.ones(32, np.float32), rows1))
    return np.asarray(margin)


@pytest.mark.parametrize("tag", ["flat", "hybrid"])
def test_gbdt_round_matches_jax_round(ranks, tag):
    if tag == "flat":
        jmesh = jax_make_mesh({"data": 2, "model": 2},
                              devices=jax.devices()[:N])
        axis = "data"
    else:
        jmesh = jax_hybrid({"ici_data": 1, "model": 2}, {"dcn_data": 2})
        axis = ("dcn_data", "ici_data")
    want = _jax_round(jmesh, axis, ranks[0]["gbdt_boundaries"])
    assert np.abs(want).max() > 0
    for r, got in enumerate(ranks):
        # rank r's rows are the block at its row coordinate, r // 2 on both
        lo = 16 * (r // 2)
        np.testing.assert_allclose(got["gbdt_" + tag], want[lo:lo + 16],
                                   rtol=0, atol=1e-5)
