"""PyTorch port vs the JAX package: fleet ingest and its lease plane.

``plan_units`` must give identical unit specs in both packages; the
port's ``ShardLeaseCoordinator`` and ``LeaseClient`` speak the reference's
framed wire byte for byte, so each test of the lease protocol runs with
the coordinator of one package and the client of the other as well as
port against port; the port's unit processor, worker loop and
``fleet_binner`` are held to the JAX package's on the same corpus; and
``FleetSource`` feeds the port's trainer daemon from either package's
coordinator.
"""

import functools
import json
import operator
import socket
import struct
import threading
import time

import numpy as np
import pytest

from dmlc_core_tpu.parallel import fleet_ingest as jax_fleet
from dmlc_core_tpu.tracker import rendezvous as jax_rdv
from dmlc_core_tpu_torch.parallel import fleet_ingest
from dmlc_core_tpu_torch.tracker import rendezvous

ROWS = 2000
FEATURES = 5

# (coordinator package, client package)
SIDES = {"port-port": (rendezvous, fleet_ingest),
         "jax-port": (jax_rdv, fleet_ingest),
         "port-jax": (rendezvous, jax_fleet)}


@pytest.fixture(params=sorted(SIDES))
def sides(request):
    return SIDES[request.param]


@pytest.fixture
def corpus(tmp_path):
    """libsvm corpus whose LABEL is the row id: the ground truth the
    exactly-once checks reconcile against."""
    path = tmp_path / "fleet.libsvm"
    rng = np.random.RandomState(0)
    with open(path, "w") as f:
        for i in range(ROWS):
            feats = " ".join(f"{j}:{rng.randn():.4f}"
                             for j in range(FEATURES))
            f.write(f"{i} {feats}\n")
    return str(path)


def _units(corpus, num_workers=2, **kwargs):
    kwargs.setdefault("fmt", "libsvm")
    kwargs.setdefault("ledger_labels", True)
    return fleet_ingest.plan_units(corpus, num_workers, **kwargs)


def _check_exactly_once(ledger, rows=ROWS):
    got = sum(e["rows"] for e in ledger.values())
    id_sum = sum(e["payload"]["id_sum"] for e in ledger.values())
    id_xor = 0
    for e in ledger.values():
        id_xor ^= e["payload"]["id_xor"]
    assert got == rows, f"row count {got} != {rows}"
    assert id_sum == rows * (rows - 1) // 2, "row-id sum off: lost/dup rows"
    assert id_xor == functools.reduce(operator.xor, range(rows))


# -- unit planning ------------------------------------------------------------
PLANS = [dict(num_workers=3),
         dict(num_workers=2, num_units=7),
         dict(num_workers=4, units_per_worker=3, fmt="libsvm"),
         dict(num_workers=1, num_units=5, dense_features=FEATURES,
              ledger_labels=True),
         dict(num_workers=2, fmt="csv", nthread=2, threaded=True)]


@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_plan_units_identical_specs(corpus, plan):
    kw = PLANS[plan]
    got = fleet_ingest.plan_units(corpus, **kw)
    assert got == jax_fleet.plan_units(corpus, **kw)
    specs = [json.loads(u) for u in got]
    assert [s["part"] for s in specs] == list(range(len(got)))


def test_plan_units_env_default(corpus, monkeypatch):
    assert len(_units(corpus, num_workers=3)) == 24   # 3 x the default 8
    monkeypatch.setenv("DMLC_FLEET_UNITS_PER_WORKER", "2")
    assert len(_units(corpus, num_workers=3)) == 6
    assert _units(corpus, num_workers=3) == jax_fleet.plan_units(
        corpus, 3, fmt="libsvm", ledger_labels=True)


@pytest.mark.parametrize("uri,fmt", [("data.parquet", "auto"),
                                     ("data.bin", "arrow"),
                                     ("data.bin?format=parquet", "auto")])
def test_columnar_units_not_ported(tmp_path, uri, fmt):
    """Fleet units may be columnar (row groups / record batches): the port
    plans them as the JAX package does, and each unit's commit payload
    (rows, batches, label-id ledger, densified) equals the JAX one."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.RandomState(2)
    cols = {"label": pa.array(np.arange(ROWS, dtype=np.float32))}
    for j in range(FEATURES):
        cols[f"f{j}"] = pa.array(rng.randn(ROWS).astype(np.float32))
    table = pa.table(cols)
    path = str(tmp_path / uri.split("?")[0])
    if fmt == "arrow":
        with pa.ipc.new_file(path, table.schema) as writer:
            for batch in table.to_batches(max_chunksize=300):
                writer.write_batch(batch)
    else:
        pq.write_table(table, path, row_group_size=300)
    full = str(tmp_path / uri)
    units = fleet_ingest.plan_units(full, 2, fmt=fmt, num_units=5,
                                    dense_features=FEATURES,
                                    ledger_labels=True)
    assert units == jax_fleet.plan_units(full, 2, fmt=fmt, num_units=5,
                                         dense_features=FEATURES,
                                         ledger_labels=True)
    total = 0
    for spec_json in units:
        spec = json.loads(spec_json)
        payload = fleet_ingest.default_unit_processor(spec)
        assert payload == jax_fleet.default_unit_processor(spec)
        total += payload["rows"]
    assert total == ROWS


@pytest.mark.parametrize("dense", [0, FEATURES])
def test_unit_processor_matches_jax(corpus, dense):
    units = _units(corpus, num_workers=2, num_units=7,
                   dense_features=dense)
    total_rows = total_ids = 0
    for spec_json in units:
        spec = json.loads(spec_json)
        payload = fleet_ingest.default_unit_processor(spec)
        assert payload == jax_fleet.default_unit_processor(spec)
        total_rows += payload["rows"]
        total_ids += payload["id_sum"]
    assert total_rows == ROWS
    assert total_ids == ROWS * (ROWS - 1) // 2


# -- the lease protocol, each side against the other --------------------------
def test_dynamic_two_workers_exactly_once(corpus, sides):
    rdv, fleet = sides
    units = _units(corpus, num_workers=2, num_units=8)
    coord = rdv.ShardLeaseCoordinator("127.0.0.1", units, lease_timeout=5.0)
    coord.start()
    results = {}

    def work(i):
        results[i] = fleet.run_worker(f"w{i}", "127.0.0.1", coord.port,
                                      lease_timeout=5.0)

    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        ledger = coord.result(timeout=10)
    finally:
        coord.stop()
    _check_exactly_once(ledger)
    assert coord.committed_total == 8 and coord.reassigned_total == 0
    assert sum(r.rows for r in results.values()) == ROWS
    assert sum(r.units_committed for r in results.values()) == 8
    assert {e["worker"] for e in ledger.values()} <= {"w0", "w1"}


def test_lease_expiry_reassignment_and_commit_rejection(corpus, sides):
    rdv, fleet = sides
    units = _units(corpus, num_workers=2, num_units=2)
    coord = rdv.ShardLeaseCoordinator("127.0.0.1", units, lease_timeout=0.3)
    coord.start()
    try:
        dead = fleet.LeaseClient("127.0.0.1", coord.port, "dead")
        unit_id, spec = dead.acquire()
        assert unit_id >= 0 and spec == units[unit_id]
        time.sleep(0.5)           # no heartbeat: the lease expires
        thief = fleet.LeaseClient("127.0.0.1", coord.port, "thief")
        assert thief.acquire()[0] == unit_id
        assert coord.reassigned_total == 1
        assert "dead" in coord.failed_workers
        assert dead.commit(unit_id, {"rows": 11}) is False
        assert coord.rejected_total == 1
        assert thief.commit(unit_id, {"rows": 11}) is True
        assert coord.ledger()[unit_id]["worker"] == "thief"
        # an idempotent retry from the committed holder is acked once
        assert thief.commit(unit_id, {"rows": 11}) is True
        assert coord.committed_total == 1
    finally:
        coord.stop()


def test_acquire_retry_redelivers_held_lease(corpus, sides):
    rdv, fleet = sides
    units = _units(corpus, num_workers=1, num_units=3)
    coord = rdv.ShardLeaseCoordinator("127.0.0.1", units, lease_timeout=5.0)
    coord.start()
    try:
        client = fleet.LeaseClient("127.0.0.1", coord.port, "w0")
        first = client.acquire()
        assert client.acquire() == first      # a lost reply, retried
        assert coord.assigned_total == 1
        assert client.commit(first[0], {"rows": 1}) is True
        nxt, _ = client.acquire()
        assert nxt not in (-1, -2) and nxt != first[0]
    finally:
        coord.stop()


def test_renew_keeps_lease_alive(corpus, sides):
    rdv, fleet = sides
    units = _units(corpus, num_workers=1, num_units=1)
    coord = rdv.ShardLeaseCoordinator("127.0.0.1", units, lease_timeout=1.0)
    coord.start()
    try:
        holder = fleet.LeaseClient("127.0.0.1", coord.port, "holder")
        unit_id, _ = holder.acquire()
        for _ in range(4):       # 1.2 s in all: past the lease, renewed
            time.sleep(0.3)
            assert holder.renew() == 1
        other = fleet.LeaseClient("127.0.0.1", coord.port, "other")
        assert other.acquire()[0] == -1
        assert holder.commit(unit_id, {"rows": 5}) is True
        assert other.acquire()[0] == -2
        assert coord.reassigned_total == 0
    finally:
        coord.stop()


def test_static_mode_never_steals(corpus, sides):
    rdv, fleet = sides
    units = _units(corpus, num_workers=2, num_units=2)
    coord = rdv.ShardLeaseCoordinator("127.0.0.1", units, mode="static",
                                      world_size=2, lease_timeout=0.2)
    coord.start()
    try:
        dead = fleet.LeaseClient("127.0.0.1", coord.port, "dead")
        assert dead.acquire(worker_index=0)[0] == 0
        time.sleep(0.4)
        other = fleet.LeaseClient("127.0.0.1", coord.port, "other")
        assert other.acquire(worker_index=1)[0] == 1
        assert other.commit(1, {"rows": 3}) is True
        assert other.acquire(worker_index=1)[0] == -2
        assert coord.reassigned_total == 0
        with pytest.raises(Exception, match="incomplete"):
            coord.result(timeout=0.2)
    finally:
        coord.stop()


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_bad_frames_rejected_coordinator_survives(corpus, impl):
    """Hostile frames from the other package's framing reach the port's
    coordinator (and the port's framing reaches the JAX coordinator)."""
    coord_mod, framed_mod = ((rendezvous, jax_rdv) if impl == "port"
                             else (jax_rdv, rendezvous))
    units = _units(corpus, num_workers=1, num_units=1)
    coord = coord_mod.ShardLeaseCoordinator("127.0.0.1", units,
                                            lease_timeout=5.0,
                                            sock_timeout=1.0)
    coord.start()
    try:
        with socket.create_connection(("127.0.0.1", coord.port)) as sock:
            sock.sendall(struct.pack("@i", 0xBEEF))
            sock.settimeout(2.0)
            assert sock.recv(4) == b""
        with socket.create_connection(("127.0.0.1", coord.port)) as sock:
            sk = framed_mod.FramedSocket(sock, timeout=2.0)
            sk.sendint(rendezvous.LEASE_MAGIC)
            assert sk.recvint() == jax_rdv.LEASE_MAGIC == 0xFF9A
            sk.sendstr("w0")
            sk.sendstr("gimme")
        client = fleet_ingest.LeaseClient("127.0.0.1", coord.port, "w0")
        unit_id, _ = client.acquire()
        with socket.create_connection(("127.0.0.1", coord.port)) as sock:
            sk = framed_mod.FramedSocket(sock, timeout=2.0)
            sk.sendint(rendezvous.LEASE_MAGIC)
            assert sk.recvint() == rendezvous.LEASE_MAGIC
            sk.sendstr("w0")
            sk.sendstr("commit")
            sk.sendint(unit_id)
            sk.sendstr("not json")
        assert coord.committed_total == 0
        assert client.commit(unit_id, {"rows": 1}) is True
        assert coord.alive()
    finally:
        coord.stop()


def test_framed_socket_bytes_match_jax():
    """Both packages' framing put the same bytes on the wire."""
    def frames(mod):
        a, b = socket.socketpair()
        with a, b:
            sk = mod.FramedSocket(a, timeout=2.0)
            sk.sendint(mod.LEASE_MAGIC)
            sk.sendstr("wörker-7")
            sk.sendint(-2)
            a.shutdown(socket.SHUT_WR)
            out = b""
            while True:
                chunk = b.recv(4096)
                if not chunk:
                    return out
                out += chunk

    assert frames(rendezvous) == frames(jax_rdv)
    assert rendezvous.DEFAULT_LEASE_TIMEOUT == jax_rdv.DEFAULT_LEASE_TIMEOUT
    assert rendezvous.MAX_FRAME == jax_rdv.MAX_FRAME


def test_unreachable_coordinator_raises_tracker_error():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    client = fleet_ingest.LeaseClient("127.0.0.1", port, "w0", retries=2)
    with pytest.raises(rendezvous.TrackerError, match="unreachable"):
        client.acquire()


def test_worker_run_requires_port():
    with pytest.raises(ValueError, match="port"):
        fleet_ingest.run_worker("w0", "127.0.0.1", None)


# -- the fleet binner ---------------------------------------------------------
def test_fleet_binner_matches_jax(corpus):
    units = _units(corpus, num_workers=1, num_units=6,
                   dense_features=FEATURES)
    results = {}
    for name, rdv, fleet in (("port", rendezvous, fleet_ingest),
                             ("jax", jax_rdv, jax_fleet)):
        coord = rdv.ShardLeaseCoordinator("127.0.0.1", units,
                                          mode="static", world_size=1,
                                          lease_timeout=5.0)
        coord.start()
        try:
            results[name] = fleet.run_worker(
                "w0", "127.0.0.1", coord.port, worker_index=0,
                lease_timeout=5.0, binner_bins=32)
            coord.result(timeout=10)
        finally:
            coord.stop()
    port, ref = results["port"], results["jax"]
    assert port.unit_ids == ref.unit_ids and port.rows == ref.rows == ROWS
    np.testing.assert_array_equal(port.summary_points, ref.summary_points)
    np.testing.assert_array_equal(port.summary_counts, ref.summary_counts)
    got = fleet_ingest.fleet_binner(port)
    want = jax_fleet.fleet_binner(ref)
    assert got.boundaries.shape == (FEATURES, 31)
    np.testing.assert_array_equal(got.boundaries, want.boundaries)
    probe = np.random.RandomState(1).randn(64, FEATURES).astype(np.float32)
    np.testing.assert_array_equal(got.transform(probe),
                                  want.transform(probe))


def test_fleet_binner_guards():
    with pytest.raises(ValueError, match="binner_bins"):
        fleet_ingest.fleet_binner(fleet_ingest.WorkerResult(worker_id="w0"))
    result = fleet_ingest.WorkerResult(
        worker_id="w0", binner_bins=8,
        summary_points=np.zeros((1, 2, 64), np.float32),
        summary_counts=np.ones((1, 2), np.float32))
    with pytest.raises(ValueError, match="handle_missing"):
        fleet_ingest.fleet_binner(result, handle_missing=True)


# -- FleetSource feeds the trainer daemon -------------------------------------
@pytest.mark.parametrize("coord_pkg", ["port", "jax"])
def test_fleet_source_feeds_daemon(tmp_path, coord_pkg):
    from dmlc_core_tpu_torch.bridge.checkpoint import load_checkpoint
    from dmlc_core_tpu_torch.models.gbdt import GBDTParam
    from dmlc_core_tpu_torch.train import CURSOR_KEY, FleetSource, \
        TrainerDaemon

    n_units = 4
    corpus = tmp_path / "train.libsvm"
    rng = np.random.RandomState(11)
    x = rng.randn(400, FEATURES)
    y = (x[:, 0] + 0.3 * rng.randn(400) > 0).astype(int)
    with open(corpus, "w") as f:
        for row, label in zip(x, y):
            f.write(f"{label} " + " ".join(f"{j}:{v:.5f}"
                                           for j, v in enumerate(row))
                    + "\n")
    rdv = rendezvous if coord_pkg == "port" else jax_rdv
    units = fleet_ingest.plan_units(str(corpus), 1, num_units=n_units,
                                    fmt="libsvm")
    coord = rdv.ShardLeaseCoordinator("127.0.0.1", units, lease_timeout=10.0)
    coord.start()
    try:
        src = FleetSource("w0", FEATURES, host="127.0.0.1",
                          port=coord.port).start()
        rows = []
        real_next = src.next_batch

        def counting(cursor):
            batch = real_next(cursor)
            if batch is not None:
                rows.append(len(batch.label))
            return batch

        src.next_batch = counting
        d = TrainerDaemon(str(tmp_path / "ckpt"), src, FEATURES,
                          param=GBDTParam(num_bins=16, max_depth=3,
                                          learning_rate=0.3),
                          rounds_per_batch=1, publish_every_rounds=2,
                          poll_s=0.05, device="cpu")
        d.run(exit_when_idle=True)
        ledger = coord.result(timeout=10)
    finally:
        coord.stop()
    # every unit committed once, every row trained on once
    assert len(ledger) == n_units and coord.committed_total == n_units
    assert sum(e["rows"] for e in ledger.values()) == 400 == sum(rows)
    assert d.rounds_completed == n_units
    step, _ = d.manager.latest_valid(verify=True)
    flat = load_checkpoint(d.manager.step_uri(step))
    assert int(np.asarray(flat[f"['{CURSOR_KEY}']"])[0]) == n_units
