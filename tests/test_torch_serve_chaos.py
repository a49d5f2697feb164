"""The port's serving chaos suite: the SLO degradation contract under
injected faults, on both transports.

The cases of ``tests/test_serve_chaos.py`` run against the port's
``ScoringServer`` serving the port's linear runtime on the CPU, driven by
the port's load generator: a stalled batch consumer, a killed predict
call, a 503 storm, a connection reset, malformed bodies, a combined plan,
the counters, a 504 and a self-healing batcher.  Every request completes
or is shed with a structured answer; the server never dies or hangs.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.serve import ScoringServer, build_runtime
from dmlc_core_tpu_torch.serve.loadgen import run_load

pytestmark = pytest.mark.chaos

NF = 4


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    fault.clear()
    yield
    fault.clear()


# every chaos drill runs against BOTH transports (threaded + evloop) with
# zero test forks: _server() resolves DMLC_SERVE_TRANSPORT from the env
@pytest.fixture(autouse=True, params=["threaded", "evloop"])
def _transport(request, monkeypatch):
    monkeypatch.setenv("DMLC_SERVE_TRANSPORT", request.param)
    yield request.param


def _server(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 1.0)
    return ScoringServer(build_runtime("linear", NF, seed=0, device="cpu"),
                         **kw)


def _post(url, obj, timeout=10.0):
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(
        url + "/v1/score", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e), dict(e.headers)


def _healthy(url):
    with urllib.request.urlopen(url + "/healthz", timeout=5) as resp:
        return json.load(resp)["status"] == "ok"


def test_queue_stall_sheds_with_structured_503_and_retry_after():
    # the consumer stalls on every batch; a tiny byte budget means the
    # queue fills after a few requests and admission must shed — with a
    # parseable envelope and a Retry-After the client can obey
    fault.configure({"rules": [{"site": "serve.queue", "kind": "stall",
                                "seconds": 0.3, "times": None}]})
    row_bytes = NF * 4
    with _server(max_queue_bytes=row_bytes * 6) as srv:
        outcomes = []
        lock = threading.Lock()

        def client():
            status, body, headers = _post(
                srv.url, {"instances": [[0.0] * NF]}, timeout=15.0)
            with lock:
                outcomes.append((status, body, headers))

        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert len(outcomes) == 16
        sheds = [(b, h) for s, b, h in outcomes if s == 503]
        oks = [s for s, _, _ in outcomes if s == 200]
        assert sheds, "admission never shed under a stalled consumer"
        assert oks, "nothing completed at all"
        for body, headers in sheds:
            assert body["error"]["code"] == "overloaded"
            assert body["error"]["retry_after"] >= 1
            assert int(headers["Retry-After"]) >= 1
        assert _healthy(srv.url)
    # the stall fired at the queue site (not somewhere incidental)
    assert any(site == "serve.queue" for site, _, _ in fault.fires())


def test_predict_kill_mid_batch_sheds_that_batch_and_recovers():
    fault.configure({"rules": [{"site": "serve.predict", "kind": "error",
                                "exception": "RuntimeError",
                                "message": "killed predict worker",
                                "times": 1}]})
    with _server() as srv:
        status, body, headers = _post(srv.url, {"instances": [[1.0] * NF]})
        assert status == 503
        assert body["error"]["code"] == "predict_failed"
        assert "killed predict worker" in body["error"]["message"]
        assert int(headers["Retry-After"]) >= 1
        # the batcher survived: the very next request computes normally
        status, body, _ = _post(srv.url, {"instances": [[1.0] * NF]})
        assert status == 200 and len(body["predictions"]) == 1
        assert _healthy(srv.url)


def test_injected_503_storm_every_request_structured():
    fault.configure({
        "seed": 5,
        "rules": [
            {"site": "serve.request", "kind": "http_status", "status": 503,
             "headers": {"retry-after": "1"},
             "body": json.dumps({"error": {"code": "overloaded",
                                           "message": "storm"}}),
             "times": 8},
            {"site": "serve.request", "kind": "stall", "seconds": 0.02,
             "probability": 0.3, "times": None},
        ]})
    with _server() as srv:
        report = run_load(srv.url, qps=60, duration_s=1.5, num_feature=NF,
                          seed=9, timeout_s=8.0)
        counts = report["counts"]
        assert counts["crashed"] == 0 and counts["error"] == 0
        assert counts["shed"] >= 8      # the whole storm surfaced as 503s
        assert counts["ok"] > 0         # and traffic flowed around it
        assert _healthy(srv.url)


def test_connection_reset_kills_one_request_not_the_server():
    fault.configure({"rules": [{"site": "serve.request", "kind": "reset",
                                "times": 1}]})
    with _server() as srv:
        with pytest.raises((urllib.error.URLError, ConnectionError)):
            _post(srv.url, {"instances": [[0.5] * NF]})
        # one torn connection; every later request is served
        status, _, _ = _post(srv.url, {"instances": [[0.5] * NF]})
        assert status == 200
        assert _healthy(srv.url)


def test_malformed_bodies_rejected_structurally_during_chaos():
    # hostile input + active faults together: parse rejection must stay
    # structured even while the predict path is being stalled
    fault.configure({"rules": [{"site": "serve.predict", "kind": "delay",
                                "seconds": 0.02, "times": None}]})
    with _server() as srv:
        for raw, want_code in [
            (b"\xff\xfe not even text", "bad_request"),
            (b"{\"instances\": [[1,2]]}", "bad_request"),     # wrong width
            (b"{\"instances\": [{\"index\": [99], \"value\": [1]}]}",
             "bad_request"),                                  # oob feature
        ]:
            status, body, _ = _post(srv.url, raw)
            assert status == 400
            assert body["error"]["code"] == want_code
            assert body["error"]["message"]
        # a well-formed request still scores
        status, _, _ = _post(srv.url, {"instances": [[0.0] * NF]})
        assert status == 200


def test_degradation_contract_under_combined_plan_zero_crashed():
    # the CI smoke in miniature: stalls + storm + one predict kill at
    # once; nothing may crash, sheds must be visible, service stays up
    fault.configure({
        "seed": 6,
        "rules": [
            {"site": "serve.request", "kind": "http_status", "status": 503,
             "headers": {"retry-after": "1"},
             "body": json.dumps({"error": {"code": "overloaded",
                                           "message": "storm"}}),
             "after": 5, "times": 5},
            {"site": "serve.queue", "kind": "stall", "seconds": 0.1,
             "after": 3, "times": 3},
            {"site": "serve.predict", "kind": "error",
             "exception": "RuntimeError", "message": "killed", "after": 2,
             "times": 1},
        ]})
    with _server() as srv:
        report = run_load(srv.url, qps=80, duration_s=2.0, num_feature=NF,
                          seed=13, timeout_s=8.0)
        counts = report["counts"]
        assert counts["crashed"] == 0 and counts["error"] == 0
        assert counts["ok"] > 0 and counts["shed"] > 0
        fired_sites = {site for site, _, _ in fault.fires()}
        assert {"serve.request", "serve.queue",
                "serve.predict"} <= fired_sites
        assert _healthy(srv.url)


def test_shed_and_fault_counters_reach_telemetry():
    was_enabled = telemetry.enabled()
    telemetry.enable()
    fault.configure({"rules": [{"site": "serve.predict", "kind": "error",
                                "times": 1}]})
    try:
        with _server() as srv:
            status, _, _ = _post(srv.url, {"instances": [[0.0] * NF]})
            assert status == 503
        reg = telemetry.get_registry()
        # serve metrics carry the model-slot label (defaults to the
        # runtime family on a single-model server)
        assert reg.counter("dmlc_serve_shed_total", model="linear",
                           reason="predict_failed").value >= 1
        assert reg.counter("dmlc_fault_injected_total",
                           site="serve.predict", kind="error").value >= 1
        assert reg.counter("dmlc_serve_predict_errors_total",
                           model="linear").value >= 1
    finally:
        if not was_enabled:
            telemetry.disable()


def test_timeout_is_a_structured_504():
    # predict stalls longer than the request deadline: the client gets a
    # structured 504, not a hung socket
    fault.configure({"rules": [{"site": "serve.predict", "kind": "stall",
                                "seconds": 1.5, "times": None}]})
    with _server(request_timeout_s=0.3) as srv:
        status, body, _ = _post(srv.url, {"instances": [[0.0] * NF]},
                                timeout=10.0)
        assert status == 504
        assert body["error"]["code"] == "timeout"
    # note: close() may wait out the stalled batch — bounded by the rule's
    # 1.5s, well under the join timeout


def test_batcher_crash_self_heals_on_next_submit():
    # an error escaping OUTSIDE the per-batch guard (the queue site)
    # ferries out of the thread; the next request restarts it
    fault.configure({"rules": [{"site": "serve.queue", "kind": "error",
                                "exception": "RuntimeError",
                                "message": "assembly crash", "times": 1}]})
    with _server() as srv:
        status, body, _ = _post(srv.url, {"instances": [[0.0] * NF]},
                                timeout=10.0)
        # the in-flight request fails structurally (503 shed)...
        assert status == 503
        assert body["error"]["code"] == "predict_failed"
        # ...and the batcher thread is rebuilt for the next one
        status, _, _ = _post(srv.url, {"instances": [[0.0] * NF]})
        assert status == 200
        assert _healthy(srv.url)
