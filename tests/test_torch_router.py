"""The port's multi-replica tier: the reference's router tests, the
fleet under a rolling restart, a router in front of one JAX replica and
one port replica, and the ``--replicas`` CLI.

The cases of ``tests/test_router.py`` run against the port's
``RouterServer``, ``Replica`` and ``run_load``: the health state machine
and ``_pick``, then in-process replicas behind a started router
(failover, half-open recovery, a hedged straggler, structured sheds,
relayed saturation, drain) and the load generator's exactly-once
accounting.  Every subprocess replica runs with ``--device cpu``; every
wait has its own timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dmlc_core_tpu.serve import ScoringServer as JaxServer
from dmlc_core_tpu.serve import build_runtime as jax_build_runtime
from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.serve import (ModelRuntime, Overloaded,
                                       RouterServer, ScoringServer,
                                       build_runtime)
from dmlc_core_tpu_torch.serve.router import (DEGRADE_AFTER, EJECT_AFTER,
                                              HALF_OPEN_PROBES, Replica,
                                              _retry_after_s)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SumRuntime(ModelRuntime):
    """Row sums, optionally slowed — the straggler/saturation stand-in."""

    name = "sum"

    def __init__(self, num_feature=4, delay_s=0.0):
        super().__init__(num_feature)
        self.delay_s = delay_s

    def predict(self, x):
        if self.delay_s:
            time.sleep(self.delay_s)
        return x.sum(axis=1)


def post(url, obj, timeout=10.0, path="/v1/score"):
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def get(url, path, timeout=10.0):
    with urllib.request.urlopen(url + path, timeout=timeout) as resp:
        return resp.status, json.load(resp)


def make_server(delay_s=0.0, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 1.0)
    return ScoringServer(SumRuntime(delay_s=delay_s), **kw).start()


def counter(name, **labels):
    total = 0.0
    for fam in telemetry.get_registry().families():
        if fam.name != name:
            continue
        for key, child in fam.samples():
            kd = dict(key)
            if all(kd.get(k) == v for k, v in labels.items()):
                total += child.value
    return total


@pytest.fixture(autouse=True)
def _telemetry_on():
    telemetry.enable()
    yield


# -- Replica health state machine ---------------------------------------------

def test_retry_after_clamped_to_sane_window():
    assert _retry_after_s("2") == 2.0
    assert _retry_after_s("0") == 1.0          # floor: never hot-loop
    assert _retry_after_s("600") == 30.0       # cap: never park a replica
    assert _retry_after_s("garbage") == 1.0
    assert _retry_after_s(None) == 1.0


def test_replica_degrades_then_ejects_on_consecutive_failures():
    rep = Replica("http://127.0.0.1:1", "r0")
    assert rep.state == "healthy"
    rep.note_failure()
    assert DEGRADE_AFTER == 1 and rep.state == "degraded"
    for _ in range(EJECT_AFTER - 1):
        rep.note_failure()
    assert rep.state == "ejected"
    # a routed success (any HTTP response) clears the whole slate
    rep.note_success()
    assert rep.state == "healthy" and rep.failures == 0


def test_replica_half_open_recovery_needs_consecutive_probes():
    rep = Replica("http://127.0.0.1:1", "r0")
    for _ in range(EJECT_AFTER):
        rep.note_failure()
    assert rep.state == "ejected"
    ok = {"status": "ok"}
    rep.note_probe(ok)
    assert rep.state == "ejected" and rep.half_open
    # a failed probe resets the streak: recovery demands consecutiveness
    rep.note_failure()
    assert not rep.half_open
    for _ in range(HALF_OPEN_PROBES):
        rep.note_probe(ok)
    assert rep.state == "healthy" and not rep.half_open


def test_replica_draining_healthz_parks_it_without_failure_counting():
    rep = Replica("http://127.0.0.1:1", "r0")
    rep.note_probe({"status": "draining"})
    assert rep.state == "draining" and rep.failures == 0
    rep.note_probe({"status": "ok"})
    # back from drain: half-open trial, not instant trust
    assert rep.half_open or rep.state == "healthy"


def test_replica_probe_parses_admission_queue_state():
    rep = Replica("http://127.0.0.1:1", "r0")
    rep.note_probe({"status": "ok", "admission": {
        "m": {"queue_bytes": 512, "max_queue_bytes": 2048,
              "shed_ewma": 0.1}}})
    assert rep.queue_bytes == 512
    assert rep.queue_fraction == pytest.approx(0.25)


# -- routing policy ------------------------------------------------------------

def _router_for(urls, **kw):
    # bare construction: no .start(), so no probe thread interferes with
    # hand-set replica states
    kw.setdefault("probe_interval_s", 60.0)
    return RouterServer(urls, **kw)


def test_pick_prefers_healthy_and_least_loaded():
    r = _router_for(["http://h:1", "http://h:2", "http://h:3"])
    r.replicas[0].note_failure()           # degraded: rank 1
    r.replicas[1].begin()                  # healthy but busier
    picked = r._pick(frozenset())
    assert picked is r.replicas[2]


def test_pick_skips_ejected_and_excluded():
    r = _router_for(["http://h:1", "http://h:2"])
    for _ in range(EJECT_AFTER):
        r.replicas[0].note_failure()
    assert r._pick(frozenset()) is r.replicas[1]
    with pytest.raises(Overloaded) as ei:
        r._pick(frozenset({"r1"}))
    assert ei.value.details["reason"] == "no_replicas"


def test_pick_all_saturated_is_structured_with_earliest_expiry():
    r = _router_for(["http://h:1", "http://h:2"])
    r.replicas[0].note_saturated(9.0)
    r.replicas[1].note_saturated(4.0)
    with pytest.raises(Overloaded) as ei:
        r._pick(frozenset())
    err = ei.value
    assert err.details["reason"] == "all_saturated"
    # earliest expiry, clamped to [1, 30]
    assert 1.0 <= err.retry_after <= 4.0


def test_pick_half_open_admits_exactly_one_trial():
    r = _router_for(["http://h:1"])
    rep = r.replicas[0]
    for _ in range(EJECT_AFTER):
        rep.note_failure()
    rep.note_probe({"status": "ok"})
    assert rep.half_open
    assert r._pick(frozenset()) is rep
    rep.begin()  # the trial is in flight: nobody else may pile on
    with pytest.raises(Overloaded):
        r._pick(frozenset())


# -- end-to-end over real replicas --------------------------------------------

@pytest.fixture()
def duo():
    """Two in-process replicas behind a started router."""
    a, b = make_server(), make_server()
    router = RouterServer([a.url, b.url], probe_interval_s=0.1,
                          try_timeout_s=2.0, request_timeout_s=8.0,
                          hedge=False)
    router.start()
    try:
        yield router, a, b
    finally:
        router.close()
        for s in (a, b):
            try:
                s.close()
            except Exception:
                pass


def test_router_forwards_and_names_the_replica(duo):
    router, a, b = duo
    status, body, headers = post(router.url, {"instances": [[1, 2, 3, 4]]})
    assert status == 200
    assert body["predictions"] == [pytest.approx(10.0)]
    assert headers.get("X-Dmlc-Replica") in ("r0", "r1")
    status, health = get(router.url, "/healthz")
    assert status == 200 and health["role"] == "router"
    assert health["routable"] == 2


def test_router_fails_over_when_a_replica_dies(duo):
    router, a, b = duo
    a.close()  # r0 is now a dead port: connect-refused, zero bytes moved
    for _ in range(8):
        status, body, headers = post(router.url,
                                     {"instances": [[1, 1, 1, 1]]})
        assert status == 200
        assert headers.get("X-Dmlc-Replica") == "r1"
    # passive failures + active probes converge r0 to ejected
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if router.replicas[0].state == "ejected":
            break
        time.sleep(0.05)
    assert router.replicas[0].state == "ejected"


def test_router_recovers_an_ejected_replica_via_half_open():
    a = make_server()
    b = make_server()
    router = RouterServer([a.url, b.url], probe_interval_s=0.1,
                          try_timeout_s=2.0, hedge=False)
    router.start()
    try:
        b.close()
        deadline = time.monotonic() + 5
        while (router.replicas[1].state != "ejected"
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert router.replicas[1].state == "ejected"
        # resurrect a server on the SAME port: probes must re-admit it
        host, port = b.address
        c = ScoringServer(SumRuntime(), host=host, port=port,
                          max_batch=4, max_delay_ms=1.0).start()
        try:
            deadline = time.monotonic() + 8
            while (router.replicas[1].state != "healthy"
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert router.replicas[1].state == "healthy"
        finally:
            c.close()
    finally:
        router.close()
        a.close()


def _warm(*servers):
    """One answer from each server, directly and through a throwaway
    router, so that the first answers the test times are not the
    process's first (cold) ones: under a loaded host a cold first answer
    from the fast replica can land after the straggler's, and the hedge
    delay the router seeds from it then outlasts the straggler."""
    for srv in servers:
        assert post(srv.url, {"instances": [[1.0, 0, 0, 0]]})[0] == 200
    warm = RouterServer([srv.url for srv in servers], probe_interval_s=60.0,
                        try_timeout_s=5.0, hedge=False)
    warm.start()
    try:
        assert post(warm.url, {"instances": [[1.0, 0, 0, 0]]})[0] == 200
    finally:
        warm.close()


def test_router_hedges_a_straggler_and_fast_replica_wins():
    fast = make_server()
    slow = make_server(delay_s=0.6)
    _warm(fast)
    router = RouterServer([slow.url, fast.url], probe_interval_s=0.2,
                          try_timeout_s=5.0, request_timeout_s=10.0,
                          hedge=True)
    router.start()
    fired0 = counter("dmlc_router_hedges_total", outcome="fired")
    won0 = counter("dmlc_router_hedges_total", outcome="hedge_won")
    try:
        t0 = time.monotonic()
        for i in range(12):
            status, body, _ = post(router.url,
                                   {"instances": [[1.0, 0, 0, float(i)]]})
            assert status == 200
            assert body["predictions"] == [pytest.approx(1.0 + i)]
        wall = time.monotonic() - t0
    finally:
        router.close()
        fast.close()
        slow.close()
    fired = counter("dmlc_router_hedges_total", outcome="fired") - fired0
    won = counter("dmlc_router_hedges_total", outcome="hedge_won") - won0
    assert fired >= 1, "a 600ms straggler never triggered a hedge"
    assert won >= 1, "no hedge ever beat the straggler"
    # 12 sequential requests, ~half primaried at the straggler: unhedged
    # that is >= 3.6s of sleeping alone
    assert wall < 12 * 0.6


def test_router_sheds_structurally_when_all_replicas_saturated(duo):
    router, a, b = duo
    for rep in router.replicas:
        rep.note_saturated(5.0)
    status, body, headers = post(router.url, {"instances": [[1, 2, 3, 4]]})
    assert status == 503
    assert body["error"]["code"] == "overloaded"
    assert body["error"]["details"]["reason"] == "all_saturated"
    assert int(headers["Retry-After"]) >= 1


def test_router_relays_replica_shed_and_marks_saturation():
    a = make_server(delay_s=0.4, max_queue_bytes=16)
    router = RouterServer([a.url], probe_interval_s=60.0,
                          try_timeout_s=5.0, hedge=False)
    router.start()
    try:
        results = []
        lock = threading.Lock()

        def fire():
            s, b, h = post(router.url, {"instances": [[1, 1, 1, 1]]})
            with lock:
                results.append((s, b, h))

        threads = [threading.Thread(target=fire) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
        statuses = sorted(s for s, _, _ in results)
        assert statuses.count(200) >= 1
        assert statuses.count(503) >= 1
        for s, b, h in results:
            if s == 503:
                assert "error" in b  # structured, not a blank reset
                assert int(h["Retry-After"]) >= 1
        assert router.replicas[0].saturated_until > 0
    finally:
        router.close()
        a.close()


# -- graceful drain (the rolling-restart building block) ----------------------

def test_drain_finishes_in_flight_and_flips_healthz():
    server = make_server(delay_s=0.5)
    url = server.url
    results = []

    def fire():
        results.append(post(url, {"instances": [[1, 2, 3, 4]]}))

    t = threading.Thread(target=fire)
    t.start()
    deadline = time.monotonic() + 5
    while server.in_flight == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.in_flight == 1

    drained = threading.Event()

    def drain():
        server.drain(timeout_s=10.0, settle_s=0.0)
        drained.set()

    d = threading.Thread(target=drain)
    d.start()
    # while draining, liveness answers but advertises the drain
    deadline = time.monotonic() + 5
    status = None
    while time.monotonic() < deadline and not drained.is_set():
        try:
            _, health = get(url, "/healthz", timeout=1.0)
            status = health["status"]
            if status == "draining":
                break
        except Exception:
            break
        time.sleep(0.01)
    t.join(10)
    d.join(15)
    assert drained.is_set()
    # the in-flight request FINISHED (200 with the right answer), it was
    # not reset by the shutdown
    assert results and results[0][0] == 200
    assert results[0][1]["predictions"] == [pytest.approx(10.0)]
    # and the port is actually closed now
    with pytest.raises(Exception):
        get(url, "/healthz", timeout=1.0)


def test_healthz_carries_per_model_admission_state():
    server = make_server()
    try:
        _, health = get(server.url, "/healthz")
        assert health["status"] == "ok"
        assert "in_flight" in health
        adm = health["admission"]
        assert len(adm) == 1
        state = next(iter(adm.values()))
        for key in ("queue_bytes", "max_queue_bytes", "shed_ewma"):
            assert key in state
        assert state["queue_bytes"] == 0
        assert 0.0 <= state["shed_ewma"] <= 1.0
    finally:
        server.close()


def test_drain_is_idempotent_and_close_safe():
    server = make_server()
    server.drain(timeout_s=1.0, settle_s=0.0)
    server.drain(timeout_s=1.0, settle_s=0.0)
    server.close()


# -- loadgen taxonomy ----------------------------------------------------------

def test_loadgen_connection_refused_is_rejected_not_crashed():
    from dmlc_core_tpu_torch.serve.loadgen import run_load

    # grab a port nothing listens on
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    report = run_load(f"http://127.0.0.1:{port}", qps=30.0, duration_s=0.5,
                      num_feature=4, seed=3, timeout_s=2.0)
    assert report["counts"]["crashed"] == 0
    assert report["counts"]["rejected"] == report["requests"] > 0
    assert report["accounting"]["ok"]


def test_loadgen_accounting_is_exactly_once_through_the_router(duo):
    from dmlc_core_tpu_torch.serve.loadgen import run_load

    router, a, b = duo
    report = run_load(router.url, qps=40.0, duration_s=1.0,
                      num_feature=4, seed=5, timeout_s=5.0)
    assert report["counts"]["crashed"] == 0
    assert report["counts"]["ok"] == report["requests"] > 0
    acct = report["accounting"]
    assert acct["recorded"] == acct["requests"] and acct["ok"]
    assert "outcome_windows" in report


def test_pool_load_through_a_router_process_checks_every_answer():
    # PoolLoad draws 1-4 rows a request (the replica's max batch) from a
    # pool and holds each 200 answer bitwise to the scores the answering
    # version must give; the router runs in a spawned process, as the
    # fleet tools drive it
    from dmlc_core_tpu_torch.serve.loadgen import (PoolLoad, RouterProcess,
                                                   load_line)

    a = make_server()
    pool = np.random.RandomState(4).randn(50, 4).astype(np.float32)
    router = RouterProcess([a.url])
    try:
        assert router.get("/healthz")["role"] == "router"
        right = PoolLoad(pool, {0: pool.sum(axis=1)}, max_rows=4)
        report, rows_s, versions = right.run(router.url, 30.0, 1.0, 6,
                                             num_feature=4, timeout_s=5.0)
        c = report["counts"]
        assert c["ok"] == report["requests"] > 0 and c["invalid"] == 0
        assert versions == {0: c["ok"]} and rows_s > 0
        assert right.rows_ok >= c["ok"]
        assert router.counter('dmlc_router_requests_total{status="200"}') \
            == c["ok"]
        line = load_line("pool", report, rows_s)
        assert line.startswith("pool: offered ") and f"ok {c['ok']}," in line
        # one ulp off on every score: every answer is wrong
        off = np.nextafter(pool.sum(axis=1), np.float32(np.inf))
        wrong = PoolLoad(pool, {0: off}, max_rows=4)
        report, _, versions = wrong.run(router.url, 30.0, 0.5, 7,
                                        num_feature=4, timeout_s=5.0)
        assert report["counts"]["invalid"] == report["requests"] > 0
        assert versions == {} and wrong.rows_ok == 0
    finally:
        router.close()
        a.close()
    assert not router.proc.is_alive()


# -- the real fleet (subprocess replicas) -------------------------------------

def test_fleet_rolling_restart_under_load_zero_crashed(tmp_path):
    from dmlc_core_tpu_torch.serve.fleet import ReplicaFleet
    from dmlc_core_tpu_torch.serve.loadgen import run_load

    fleet = ReplicaFleet(2, model="linear", num_feature=4, seed=0,
                         max_batch=8, max_delay_ms=1.0, warmup=False,
                         log_dir=str(tmp_path / "logs"), device="cpu")
    fleet.start(timeout_s=60)
    router = RouterServer(fleet.urls, probe_interval_s=0.15,
                          try_timeout_s=3.0, request_timeout_s=8.0)
    router.start()
    try:
        done = threading.Event()

        def roll():
            try:
                time.sleep(1.0)
                fleet.rolling_restart(settle_s=0.3, timeout_s=40)
            finally:
                done.set()

        t = threading.Thread(target=roll)
        t.start()
        report = run_load(router.url, qps=25.0, duration_s=10.0,
                          num_feature=4, seed=11, timeout_s=8.0)
        t.join(60)
    finally:
        router.close()
        fleet.close()
    assert done.is_set(), "rolling restart never completed"
    assert fleet.launches() == [2, 2]
    c = report["counts"]
    assert c["crashed"] == 0, f"rolling restart dropped requests: {c}"
    assert c["error"] == 0 and c["invalid"] == 0
    assert c["ok"] > 0
    assert report["accounting"]["ok"]


@pytest.mark.parametrize("floor", [None, 32768])
def test_fleet_ports_lie_below_the_ephemeral_range(monkeypatch, floor):
    # a replica's fixed port lies unbound between its exit and its
    # relaunch: inside the ephemeral range an outgoing connection can take
    # it in that gap, so a fleet picks ports below the range where the
    # kernel says where the range starts (and lets the kernel pick where
    # it does not)
    from dmlc_core_tpu_torch.serve import fleet as fleet_mod

    if floor is not None:
        monkeypatch.setattr(fleet_mod, "_ephemeral_floor", lambda: floor)
    else:
        monkeypatch.setattr(fleet_mod, "_ephemeral_floor", lambda: None)
    fleets = [fleet_mod.ReplicaFleet(3, num_feature=4, device="cpu")
              for _ in range(4)]
    ports = [p for f in fleets for p in f.ports]
    assert len(set(ports)) == len(ports)
    for p in ports:
        if floor is not None:
            assert fleet_mod._FIXED_PORT_FLOOR <= p < floor
        else:
            assert 0 < p < 65536
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))   # still free: nothing holds it


def test_threaded_listener_holds_a_connection_storm():
    # the router (and a threaded replica) listen on _Server: 300 fresh
    # connections arriving while nothing accepts must all complete their
    # handshake in the kernel's queue.  A shallow queue drops the excess
    # SYNs, and a client's connect retries then outlast its deadline
    import select

    from dmlc_core_tpu_torch.serve.server import _Handler, _Server

    router = RouterServer(["http://127.0.0.1:9"])
    try:
        assert isinstance(router._httpd, _Server)
    finally:
        router._httpd.server_close()
    srv = _Server(("127.0.0.1", 0), _Handler)
    socks = []
    try:
        for _ in range(300):
            s = socket.socket()
            s.setblocking(False)
            s.connect_ex(srv.server_address)
            socks.append(s)
        pending = set(socks)
        deadline = time.monotonic() + 5.0
        while pending and time.monotonic() < deadline:
            _, ready, _ = select.select([], list(pending), [], 0.5)
            for s in ready:
                assert s.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR) == 0
                pending.discard(s)
        assert not pending, f"{len(pending)} of 300 connects never completed"
    finally:
        for s in socks:
            s.close()
        srv.server_close()


# -- across the packages, and the CLI ----------------------------------------

def test_port_router_fronts_a_jax_replica_and_a_port_replica():
    # the same seeded linear model in both packages: whichever answers,
    # the scores agree within 1e-6
    jax_rep = JaxServer(jax_build_runtime("linear", 4, seed=3), max_batch=8,
                        max_delay_ms=1.0).start()
    port_rep = ScoringServer(build_runtime("linear", 4, seed=3,
                                           device="cpu"),
                             max_batch=8, max_delay_ms=1.0).start()
    router = RouterServer([jax_rep.url, port_rep.url], probe_interval_s=0.1,
                          try_timeout_s=2.0, request_timeout_s=8.0,
                          hedge=False).start()
    rows = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    want = build_runtime("linear", 4, seed=3, device="cpu").predict(rows)
    try:
        seen = set()
        for i in range(24):
            status, body, headers = post(
                router.url, {"instances": rows[i % 6:i % 6 + 1].tolist()})
            assert status == 200
            np.testing.assert_allclose(body["predictions"], want[i % 6:i % 6 + 1],
                                       rtol=0, atol=1e-6)
            seen.add(headers.get("X-Dmlc-Replica"))
        # least-loaded routing with random ties reaches both in 24 tries
        assert seen == {"r0", "r1"}
        status, health = get(router.url, "/healthz")
        assert status == 200 and health["routable"] == 2
        assert {r["state"] for r in health["replicas"].values()} \
            == {"healthy"}
        assert {r["url"] for r in health["replicas"].values()} \
            == {jax_rep.url, port_rep.url}
    finally:
        router.close()
        jax_rep.close()
        port_rep.close()


@pytest.mark.parametrize("model", ["linear", "mlp", "gbdt"])
def test_cli_replicas_behind_a_router_on_the_cpu(model):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serve", "--model", model,
         "--replicas", "2", "--transport", "evloop", "--device", "cpu",
         "--port", "0", "--no-warmup"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    killer = threading.Timer(60.0, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving {model} on http://"), \
            line + proc.stderr.read()
        assert "replicas=2" in line
        url = line.split(" on ", 1)[1].split()[0]
        status, body, headers = post(url, {"instances": [[0.5] * 28] * 3})
        assert status == 200 and body["model"] == model
        assert body["num_rows"] == 3
        assert headers.get("X-Dmlc-Replica") in ("r0", "r1")
        status, health = get(url, "/healthz")
        assert health["role"] == "router" and health["routable"] == 2
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=45)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "serve: shut down cleanly" in out


_SIGNAL_PROBE = """
import signal, sys, threading, time
from dmlc_core_tpu_torch.serve.__main__ import _wait_for_signal
stop = threading.Event()
signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
# a thread started before the mask takes SIGTERM; the main thread,
# blocked in the wait, never does (a busy replica's batcher and handler
# threads make this the common case)
threading.Thread(target=time.sleep, args=(60,), daemon=True).start()
signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})
print("ready", flush=True)
_wait_for_signal(stop)
print("stopped", flush=True)
"""


def test_cli_wait_wakes_for_a_signal_another_thread_took():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _SIGNAL_PROBE], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=20)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert out.strip() == "stopped" and proc.returncode == 0
