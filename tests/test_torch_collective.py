"""The port's collective API, mesh and mesh collectives.

In process: the single-process API (mirroring ``tests/test_collective.py``),
the rank the env contract gives and the mesh shapes, each held to the JAX
package's function on the same inputs.  Across processes: one launch of
four port workers through the JAX package's own tracker (so the env
contract the launcher writes is the one the port reads), on the CPU with
gloo, checking the API's semantics and a 2 x 2 mesh's collectives.
"""

import socket

import numpy as np
import pytest
import torch

from dmlc_core_tpu.collective.api import _task_id_from_env as jax_task_id
from dmlc_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmlc_core_tpu.utils.logging import Error as JaxError
from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.collective import api
from dmlc_core_tpu_torch.collective.mesh_collectives import MeshCollective
from dmlc_core_tpu_torch.parallel import mesh as port_mesh
from dmlc_core_tpu_torch.utils.logging import Error

_CONTRACT = ("DMLC_NUM_WORKER", "DMLC_TASK_ID", "DMLC_COORDINATOR_URI",
             "DMLC_COORDINATOR_PORT")


@pytest.fixture
def standalone(monkeypatch):
    """A process with no launcher environment: world of one."""
    for key in _CONTRACT:
        monkeypatch.delenv(key, raising=False)
    collective.init()
    yield
    collective.finalize()


def test_single_process_api(standalone):
    assert collective.is_initialized()
    assert collective.get_rank() == 0
    assert collective.get_world_size() == 1
    out = collective.allreduce(np.array([1.0, 2.0]))
    np.testing.assert_allclose(out, [1.0, 2.0])
    out = collective.broadcast(np.array([5]), root=0)
    np.testing.assert_allclose(out, [5])
    gathered = collective.allgather(np.array([7.0]))
    assert gathered.shape == (1, 1)
    collective.tracker_print("hello from rank 0")
    assert collective.version_number() == 0
    collective.finalize()
    assert not collective.is_initialized()


def test_single_process_broadcast_requires_root_value(standalone):
    out = collective.broadcast(np.arange(3.0), root=0)
    np.testing.assert_array_equal(out, np.arange(3.0))
    with pytest.raises(Error, match="root must supply"):
        collective.broadcast(None, root=0)


def test_checkpoint_waits_for_persistence_slice(standalone):
    with pytest.raises(NotImplementedError, match="bridge/checkpoint.py"):
        collective.checkpoint({"w": np.zeros(2)}, "ck-{version}")
    with pytest.raises(NotImplementedError, match="bridge/checkpoint.py"):
        collective.load_checkpoint("ck-{version}")


@pytest.mark.parametrize("env", [
    {},
    {"DMLC_TASK_ID": "3"},
    {"DMLC_TASK_ID": " 2 "},
    {"DMLC_TASK_ID": "", "SLURM_PROCID": "7"},
    {"DMLC_TASK_ID": "x1", "PMI_RANK": "5"},
    {"OMPI_COMM_WORLD_RANK": "1", "PMIX_RANK": "2"},
    {"PMIX_RANK": "4"},
    {"PMI_RANK": "6"},
    {"SLURM_PROCID": "9"},
    {"DMLC_TASK_ID": "nan", "OMPI_COMM_WORLD_RANK": "?", "PMIX_RANK": "",
     "PMI_RANK": "2.5", "SLURM_PROCID": "-"},
])
def test_task_id_from_env_matches_jax(env):
    assert api._task_id_from_env(env) == jax_task_id(env)


def _check_message(exc):
    return str(exc).split("] ", 1)[1]


@pytest.mark.parametrize("axes", [
    None, {"data": -1}, {"data": -1, "model": 2},
    {"data": 2, "model": -1, "x": 2}, {"model": 8},
    {"data": 3}, {"data": -1, "model": -1}, {"data": -1, "model": 3}])
def test_mesh_shape_matches_jax(axes):
    """-1 inference and the bad-shape checks over 8 ranks, against the JAX
    mesh over the 8 host devices of ``tests/conftest.py``."""
    try:
        want = dict(jax_make_mesh(axes).shape)
    except JaxError as exc:
        with pytest.raises(Error) as got:
            port_mesh._mesh_shape(axes, 8)
        assert _check_message(got.value) == _check_message(exc)
        return
    names, sizes = port_mesh._mesh_shape(axes, 8)
    assert dict(zip(names, sizes)) == want


def test_mesh_coordinates_are_row_major():
    for rank in range(6):
        m = port_mesh.Mesh({"data": 3, "model": 2}, rank=rank)
        assert (m.coord("data"), m.coord("model")) == divmod(rank, 2)
        d = rank // 2
        assert m.line_ranks("model") == [2 * d, 2 * d + 1]
        assert m.line_ranks("data") == [rank % 2, rank % 2 + 2,
                                        rank % 2 + 4]
        # model shards of one data shard read the same rows
        assert port_mesh.row_range(m, 10) == (d * 10 // 3,
                                              (d + 1) * 10 // 3)
    with pytest.raises(Error, match="outside a mesh"):
        port_mesh.Mesh({"data": 2}, rank=2)


def test_ambient_mesh_and_single_rank_collectives(standalone):
    assert port_mesh.ambient_mesh() is None
    mesh = port_mesh.make_mesh({"data": 1, "model": -1})
    with mesh:
        assert port_mesh.ambient_mesh() is mesh
        with port_mesh.Mesh({"data": 2}, rank=1) as inner:
            assert port_mesh.ambient_mesh() is inner
        assert port_mesh.ambient_mesh() is mesh
    assert port_mesh.ambient_mesh() is None
    assert port_mesh.local_shard_info() == (0, 1)
    x = torch.arange(6.0).reshape(2, 3)
    coll = MeshCollective(mesh, "model")
    for out in (coll.allreduce(x, "max"), coll.psum(x), coll.allgather(x),
                coll.broadcast(x), coll.reduce_scatter(x)):
        assert torch.equal(out, x)
    # a layout-only mesh cannot run a collective over a longer axis
    with pytest.raises(Error, match="no process group"):
        MeshCollective(port_mesh.Mesh({"data": 2, "model": 2}), "data")


WORKER = r"""
import os
import numpy as np
import torch
from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.collective.mesh_collectives import MeshCollective
from dmlc_core_tpu_torch.parallel.mesh import make_mesh, row_range
from dmlc_core_tpu_torch.utils.logging import Error

# the tracker's env names rank, world and coordinator; the store's port
# is the test's own (see store_port)
collective.init({"device": "cpu", "timeout": 60,
                 "DMLC_COORDINATOR_PORT": os.environ["STORE_PORT"]})
rank = collective.get_rank()
world = collective.get_world_size()
assert world == 4, world
assert collective.get_processor_name()

x = np.array([rank + 1.0, -rank], np.float32)
np.testing.assert_array_equal(collective.allreduce(x), [10.0, -6.0])
np.testing.assert_array_equal(collective.allreduce(x, "max"), [4.0, 0.0])
np.testing.assert_array_equal(collective.allreduce(x, "min"), [1.0, -3.0])
np.testing.assert_array_equal(collective.allreduce(x, "prod"), [24.0, 0.0])

# broadcast: only the root supplies the value, shape and dtype travel too
for dtype in (np.float32, np.int64, np.uint16, np.bool_):
    value = (np.arange(6).reshape(2, 3) % 3).astype(dtype)
    out = collective.broadcast(value if rank == 1 else None, root=1)
    assert out.dtype == dtype and out.shape == (2, 3), (out.dtype, out.shape)
    np.testing.assert_array_equal(out, value)
# a root-side error raises on every rank instead of hanging
try:
    collective.broadcast(None, root=0)
except Error as exc:
    assert ("root must supply" in str(exc)
            or "failed validation" in str(exc)), str(exc)
else:
    raise AssertionError("broadcast with no root value did not raise")

g = collective.allgather(np.full((2, 3), rank, np.float32))
assert g.shape == (4, 2, 3), g.shape
np.testing.assert_array_equal(g[:, 0, 0], np.arange(4))

mesh = make_mesh({"data": 2, "model": -1})
d, m = mesh.coord("data"), mesh.coord("model")
assert (d, m) == divmod(rank, 2), (d, m)
assert row_range(mesh, 10) == (5 * d, 5 * d + 5)
t = torch.tensor([float(rank)])
# along data: ranks m and m + 2; along model: ranks 2d and 2d + 1
for axis, line in (("data", [m, m + 2]), ("model", [2 * d, 2 * d + 1])):
    c = MeshCollective(mesh, axis)
    assert c.allreduce(t).item() == sum(line)
    assert c.allreduce(t, "max").item() == max(line)
    assert c.allreduce(t, "min").item() == min(line)
    assert c.psum(t).item() == sum(line)
    assert c.allgather(t).tolist() == line
    both = c.allgather(torch.tensor([[rank, -rank]]), dim=1)
    assert both.tolist() == [[line[0], -line[0], line[1], -line[1]]]
    assert c.broadcast(t, root=1).item() == line[1]
    part = torch.arange(4.0) + rank
    want = (2 * torch.arange(4.0) + sum(line))[2 * c.index:2 * c.index + 2]
    assert torch.equal(c.reduce_scatter(part), want)

collective.tracker_print(f"rank {rank} done")
assert collective.version_number() == 0
collective.finalize()
with open(os.path.join(os.environ["RESULT_DIR"], f"ok-{rank}"), "w") as f:
    f.write("ok")
"""


def store_port() -> int:
    """A free port for the workers' store.  Trackers started at the same
    moment by parallel test processes hand out the same coordinator port
    (each probes from 12321 up and closes its probe socket before the
    workers bind it), so each launch here brings its own."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_workers_through_the_tracker(tmp_path):
    from tests.conftest import run_tracker_workers

    proc = run_tracker_workers(tmp_path, WORKER, 4, timeout=120,
                               env_extra={"STORE_PORT": str(store_port())})
    assert proc.returncode == 0, proc.stderr[-4000:]
    for rank in range(4):
        assert (tmp_path / f"ok-{rank}").exists(), rank
