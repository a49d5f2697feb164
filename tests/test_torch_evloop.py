"""The port's event-loop transport: the reference's hostile-client drills,
and byte parity with the threaded transport and with the JAX event loop.

The cases of ``tests/test_serve_evloop.py`` run against the port's
``ScoringServer(transport="evloop")`` serving the port's linear runtime
on the CPU: slowloris and stalled bodies get a structured 408 and a
close, a mid-response disconnect is counted as an abort, pipelined
requests are answered in order, idle keep-alive connections are reaped,
a churn run refuses and resets nothing, and every SLO report states its
connection accounting.  Then the same requests go to both transports
(bodies byte-identical) and to the port's and the JAX package's event
loops serving one JAX-trained GBDT blob (heads, bar ``Date``, and bodies
byte-identical).
"""

import json
import socket
import struct
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dmlc_core_tpu import fault as jax_fault
from dmlc_core_tpu.bridge.checkpoint import CheckpointManager as JaxManager
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.serve import ScoringServer as JaxServer
from dmlc_core_tpu.serve import build_runtime as jax_build_runtime
from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.serve import ScoringServer, build_runtime
from dmlc_core_tpu_torch.serve.loadgen import run_churn, run_load

NF = 4


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    fault.clear()
    jax_fault.clear()
    yield
    fault.clear()
    jax_fault.clear()


def _server(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 1.0)
    kw.setdefault("transport", "evloop")
    return ScoringServer(build_runtime("linear", NF, seed=0, device="cpu"),
                         **kw)


def _post(url, obj, timeout=10.0):
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(
        url + "/v1/score", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _healthy(url):
    with urllib.request.urlopen(url + "/healthz", timeout=5) as resp:
        return json.load(resp)["status"] == "ok"


def _connect(srv):
    host, port = srv.url.replace("http://", "").rsplit(":", 1)
    return socket.create_connection((host, int(port)), timeout=10.0)


def _read_response(sock, timeout=10.0, buf=b""):
    """Read exactly one HTTP response off a raw socket; returns
    (status, headers dict, body bytes, bytes after it, head bytes)."""
    sock.settimeout(timeout)
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("EOF before response head")
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    need = int(headers.get("content-length", "0"))
    while len(rest) < need:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("EOF mid-body")
        rest += chunk
    return status, headers, rest[:need], rest[need:], head


def _request_bytes(path, payload, method="POST"):
    return (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload


# -- the reference's drills -------------------------------------------------------

def test_slowloris_headers_get_structured_408_then_close(monkeypatch):
    monkeypatch.setenv("DMLC_SERVE_HEADER_S", "0.5")
    with _server() as srv:
        s = _connect(srv)
        try:
            s.sendall(b"POST /v1/score HT")
            time.sleep(0.15)
            s.sendall(b"TP/1.1\r\nContent-")
            status, _, body, _, _ = _read_response(s, timeout=10.0)
            assert status == 408
            err = json.loads(body)["error"]
            assert err["code"] == "client_timeout"
            assert err["details"]["timeout_s"] == 0.5
            assert s.recv(1) == b""
        finally:
            s.close()
        status, body = _post(srv.url, {"instances": [[0.0] * NF]})
        assert status == 200 and len(body["predictions"]) == 1
        assert _healthy(srv.url)


def test_stalled_body_gets_structured_408_then_close(monkeypatch):
    monkeypatch.setenv("DMLC_SERVE_HEADER_S", "0.5")
    with _server() as srv:
        s = _connect(srv)
        try:
            s.sendall(b"POST /v1/score HTTP/1.1\r\n"
                      b"Host: x\r\nContent-Type: application/json\r\n"
                      b"Content-Length: 400\r\n\r\n"
                      b'{"instances": [[')
            status, _, body, _, _ = _read_response(s, timeout=10.0)
            assert status == 408
            assert json.loads(body)["error"]["code"] == "client_timeout"
            assert s.recv(1) == b""
        finally:
            s.close()
        status, _ = _post(srv.url, {"instances": [[0.5] * NF]})
        assert status == 200
        assert _healthy(srv.url)


def test_mid_response_disconnect_counted_as_abort_not_crash():
    was_enabled = telemetry.enabled()
    telemetry.enable()
    fault.configure({"rules": [{"site": "serve.predict", "kind": "delay",
                                "seconds": 0.4, "times": None}]})
    try:
        with _server() as srv:
            before = telemetry.get_registry().counter(
                "dmlc_serve_connection_aborts_total").value
            s = _connect(srv)
            s.sendall(_request_bytes("/v1/score", json.dumps(
                {"instances": [[0.0] * NF]}).encode()))
            time.sleep(0.1)  # let the loop submit to the batcher
            # SO_LINGER(0): close sends RST instead of FIN
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
            s.close()
            deadline = time.monotonic() + 5.0
            after = before
            while time.monotonic() < deadline:
                after = telemetry.get_registry().counter(
                    "dmlc_serve_connection_aborts_total").value
                if after > before:
                    break
                time.sleep(0.05)
            assert after > before, "abort was never counted"
            fault.clear()
            status, _ = _post(srv.url, {"instances": [[1.0] * NF]})
            assert status == 200
            assert _healthy(srv.url)
    finally:
        if not was_enabled:
            telemetry.disable()


def test_pipelined_requests_answered_in_order():
    with _server() as srv:
        p1 = json.dumps({"instances": [[1.0] * NF]}).encode()
        p2 = json.dumps({"instances": [[2.0] * NF, [3.0] * NF]}).encode()
        s = _connect(srv)
        try:
            s.sendall(_request_bytes("/v1/score", p1)
                      + _request_bytes("/v1/score", p2))
            status1, _, body1, extra, _ = _read_response(s)
            status2, _, body2, _, _ = _read_response(s, buf=extra)
        finally:
            s.close()
    assert status1 == status2 == 200
    assert len(json.loads(body1)["predictions"]) == 1
    assert len(json.loads(body2)["predictions"]) == 2


def test_idle_keepalive_connections_are_reaped_silently(monkeypatch):
    was_enabled = telemetry.enabled()
    telemetry.enable()
    monkeypatch.setenv("DMLC_SERVE_IDLE_S", "0.5")
    try:
        with _server() as srv:
            s = _connect(srv)
            try:
                time.sleep(1.2)  # > idle timeout + sweep period
                s.settimeout(5.0)
                assert s.recv(1) == b""
            finally:
                s.close()
            reaped = telemetry.get_registry().counter(
                "dmlc_serve_connections_closed_total",
                reason="idle_timeout").value
            assert reaped >= 1
            status, _ = _post(srv.url, {"instances": [[0.0] * NF]})
            assert status == 200
    finally:
        if not was_enabled:
            telemetry.disable()


def test_churn_report_shows_zero_refused_zero_resets(monkeypatch):
    monkeypatch.setenv("DMLC_SERVE_IDLE_S", "60")
    with _server() as srv:
        report = run_churn(srv.url, connections=256, duration_s=1.5,
                           num_feature=NF, active=8, churn_per_s=20,
                           seed=3)
        conns = report["connections"]
        assert conns["refused"] == 0
        assert conns["resets"] == 0
        assert conns["closed_by_server"] == 0
        assert conns["peak_open"] >= 256
        assert conns["churned"] > 0
        assert report["requests"]["ok"] > 0
        assert report["requests"]["errors"] == 0
        assert _healthy(srv.url)


def test_every_slo_report_carries_connection_accounting():
    with _server() as srv:
        report = run_load(srv.url, qps=30, duration_s=1.0,
                          num_feature=NF, seed=7)
        conns = report["connections"]
        assert set(conns) == {"peak_inflight", "refused", "resets"}
        assert conns["peak_inflight"] >= 1
        assert conns["refused"] == 0 and conns["resets"] == 0
        assert report["counts"]["crashed"] == 0


# -- byte parity ------------------------------------------------------------------

def _exchange(url, nf):
    """One request per fresh connection, and a pipelined pair; returns
    (status, head lines without Date, body) of every answer."""
    row = [0.5] * nf
    rng = np.random.RandomState(3)
    requests = [
        ("POST", "/v1/score", json.dumps(
            {"instances": rng.randn(5, nf).round(4).tolist()}).encode()),
        ("POST", "/v1/score", json.dumps({"instances": [row[:-1]]}).encode()),
        ("POST", "/v1/score", b"{not json"),
        ("POST", "/v1/score", json.dumps(
            {"instances": [{"index": [0, nf - 1], "value": [1, 2]}]}).encode()),
        ("POST", "/v1/score/nope", json.dumps({"instances": [row]}).encode()),
        ("POST", "/v1/other", json.dumps({"instances": [row]}).encode()),
        ("GET", "/nope", b""),
    ]
    host, port = url.replace("http://", "").rsplit(":", 1)
    out = []

    def keep(answer):
        status, _, body, rest, head = answer
        lines = [ln for ln in head.split(b"\r\n")
                 if not ln.lower().startswith(b"date:")]
        out.append((status, lines, body))
        return rest

    for method, path, payload in requests:
        with socket.create_connection((host, int(port)), timeout=10) as s:
            s.sendall(_request_bytes(path, payload, method))
            keep(_read_response(s))
    pair = [json.dumps({"instances": [[float(i)] * nf]}).encode()
            for i in (1, 2)]
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(b"".join(_request_bytes("/v1/score", p) for p in pair))
        keep(_read_response(s, buf=keep(_read_response(s))))
    return out


def test_threaded_and_evloop_bodies_are_byte_identical():
    runtime = build_runtime("linear", NF, seed=2, device="cpu")
    answers = {}
    for transport in ("threaded", "evloop"):
        with ScoringServer(runtime, transport=transport, max_batch=8,
                           warmup=False) as srv:
            answers[transport] = _exchange(srv.url, NF)
    threaded, evloop = answers["threaded"], answers["evloop"]
    assert [a[0] for a in evloop] == [200, 400, 400, 200, 404, 400, 400,
                                      200, 200]
    assert [a[0] for a in threaded] == [a[0] for a in evloop]
    assert [a[2] for a in threaded] == [a[2] for a in evloop]


def test_port_and_jax_event_loops_answer_the_same_bytes(tmp_path):
    # a squared-loss GBDT scores bitwise alike in both packages (the
    # serving tests of the checkpoint slice), so whole bodies compare
    rng = np.random.RandomState(0)
    x = rng.randn(400, NF).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 2]).astype(np.float32)
    jm = JaxGBDT(JaxParam(objective="squared", num_boost_round=3,
                          max_depth=3, num_bins=16), num_feature=NF)
    jm.make_bins(x)
    ens, _ = jm.fit_binned(jm.bin_features(x), y)
    mgr = JaxManager(str(tmp_path / "m"))
    mgr.save(1, jm.serving_state(ens), async_=False)
    uri = mgr.step_uri(1)
    answers = []
    for server, rt in (
            (ScoringServer, build_runtime("gbdt", NF, checkpoint=uri,
                                          device="cpu")),
            (JaxServer, jax_build_runtime("gbdt", NF, checkpoint=uri))):
        with server(rt, max_batch=8, warmup=False,
                    transport="evloop") as srv:
            answers.append(_exchange(srv.url, NF))
    port, ref = answers
    assert [a[0] for a in port][:4] == [200, 400, 400, 200]
    assert port == ref
