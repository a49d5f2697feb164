"""PyTorch port vs the JAX package: the serving path on the CPU.

JAX-trained GBDTs at ``bench.py``'s widths (28 features, 256 bins,
depth 6) are written as ``serving_state`` checkpoints by the JAX package
and served over HTTP by the port's ``ScoringServer`` (``device="cpu"``).
The answers are held to the JAX ``GBDTRuntime`` on the same rows:
``squared`` scores and ``logistic`` margins bitwise, ``logistic``
probabilities within ``atol=1.2e-7`` (``exp`` differs by an ulp between
XLA and torch on the CPU).  The error envelopes and ``/healthz`` are
compared with the JAX server's for the same requests; a watcher hot swap
must answer every request, each bitwise equal to the model version that
answered it; and the CLI must round-trip a request and shut down cleanly.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dmlc_core_tpu import fault as jax_fault
from dmlc_core_tpu.bridge.checkpoint import CheckpointManager as JaxManager
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.serve import ScoringServer as JaxServer
from dmlc_core_tpu.serve import batch_buckets as jax_batch_buckets
from dmlc_core_tpu.serve import build_runtime as jax_build_runtime
from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                   load_checkpoint)
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.serve import (CheckpointWatcher, GBDTRuntime,
                                       MicroBatcher, ModelRegistry,
                                       ModelRuntime, PredictFailed,
                                       ScoringServer, batch_buckets,
                                       build_runtime, runtime_builder)
from dmlc_core_tpu_torch.serve.__main__ import main as serve_main
from dmlc_core_tpu_torch.serve.model_runtime import PendingResult, to_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = 28          # bench.py's widths
NB = 256
DEPTH = 6
SMALL_NF = 6
PROB_ATOL = 1.2e-7


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    fault.clear()
    jax_fault.clear()
    yield
    fault.clear()
    jax_fault.clear()


def _post(url, path, obj, timeout=20.0):
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(url + path, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=20.0) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def bench_blobs(tmp_path_factory):
    """JAX-trained ``serving_state`` blobs at bench.py's widths (3,000
    rows, 5 rounds), one per objective, plus 512 held-out rows."""
    root = tmp_path_factory.mktemp("bench_blobs")
    rng = np.random.RandomState(0)
    x = rng.randn(3512, NF).astype(np.float32)
    score = x @ rng.randn(NF).astype(np.float32)
    out = {"held": x[3000:]}
    for objective in ("squared", "logistic"):
        y = (score if objective == "squared" else score > 0)
        jm = JaxGBDT(JaxParam(objective=objective, num_boost_round=5,
                              max_depth=DEPTH, num_bins=NB), num_feature=NF)
        jm.make_bins(x[:3000])
        ens, _ = jm.fit_binned(jm.bin_features(x[:3000]),
                               y[:3000].astype(np.float32))
        mgr = JaxManager(str(root / objective))
        mgr.save(1, jm.serving_state(ens), async_=False)
        out[objective] = mgr.step_uri(1)
    return out


@pytest.mark.parametrize("objective", ["squared", "logistic"])
def test_served_scores_match_jax_at_bench_widths(bench_blobs, objective):
    uri, held = bench_blobs[objective], bench_blobs["held"]
    runtime = build_runtime("gbdt", NF, checkpoint=uri, device="cpu")
    assert isinstance(runtime, GBDTRuntime)
    jax_rt = jax_build_runtime("gbdt", NF, checkpoint=uri)
    want = np.asarray(jax_rt.predict_float(held))
    port_float = runtime.predict_float(held)
    sizes = [1, 7, 64, 33, 2, 64, 5, 48]
    starts = np.cumsum([0] + sizes[:-1])
    answers = {}

    def client(i):
        lo = int(starts[i])
        rows = held[lo:lo + sizes[i]]
        answers[i] = _post(srv.url, "/v1/score",
                           {"instances": rows.tolist()})

    with ScoringServer(runtime, max_batch=64, max_delay_ms=2.0) as srv:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    for i, n in enumerate(sizes):
        status, body = answers[i]
        assert status == 200, body
        assert body["num_rows"] == n and body["model"] == "gbdt"
        got = np.asarray(body["predictions"], np.float32)
        lo = int(starts[i])
        # the uint8 wire is bitwise the device-side float path
        np.testing.assert_array_equal(_bits(got), _bits(port_float[lo:lo + n]))
        if objective == "squared":
            np.testing.assert_array_equal(_bits(got), _bits(want[lo:lo + n]))
        else:
            np.testing.assert_allclose(got, want[lo:lo + n], rtol=0,
                                       atol=PROB_ATOL)
    # the margins under the sigmoid are bitwise the reference's
    jg, je = jax_rt.gbdt, jax_rt.ensemble
    want_margin = np.asarray(jg.predict_margin(je, jg.bin_features(held)))
    got_margin = runtime.gbdt.predict_margin(
        runtime.ensemble, runtime.binner.transform(held)).numpy()
    np.testing.assert_array_equal(_bits(got_margin), _bits(want_margin))


def _small_pair(handle_missing, objective="squared", seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(500, SMALL_NF).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 3]).astype(np.float32)
    if objective == "logistic":
        y = (y > 0).astype(np.float32)
    if handle_missing:
        x[rng.rand(*x.shape) < 0.2] = np.nan
    jm = JaxGBDT(JaxParam(objective=objective, num_boost_round=4,
                          max_depth=4, num_bins=32,
                          handle_missing=handle_missing),
                 num_feature=SMALL_NF)
    jm.make_bins(x)
    ens, _ = jm.fit_binned(jm.bin_features(x), y)
    return jm, ens, x


def test_handle_missing_model_with_nans(tmp_path):
    jm, ens, x = _small_pair(handle_missing=True)
    mgr = JaxManager(str(tmp_path / "hm"))
    mgr.save(1, jm.serving_state(ens), async_=False)
    runtime = build_runtime("gbdt", SMALL_NF, checkpoint=mgr.step_uri(1),
                            device="cpu")
    jax_rt = jax_build_runtime("gbdt", SMALL_NF, checkpoint=mgr.step_uri(1))
    rows = x[:64].copy()
    rows[0, :] = jm.boundaries[np.arange(SMALL_NF), 0]   # ties go right
    rows[1, :] = np.nan
    want = np.asarray(jax_rt.predict(rows))
    np.testing.assert_array_equal(_bits(runtime.predict(rows)), _bits(want))
    np.testing.assert_array_equal(_bits(runtime.predict_float(rows)),
                                  _bits(want))
    # NaN cannot cross JSON; a sparse row leaves absent features at 0.0
    sparse = {"index": [0, 4], "value": [0.5, -1.25]}
    dense = np.zeros((1, SMALL_NF), np.float32)
    dense[0, [0, 4]] = [0.5, -1.25]
    with ScoringServer(runtime, max_batch=8) as srv:
        status, body = _post(srv.url, "/v1/score", {"instances": [sparse]})
    assert status == 200
    np.testing.assert_array_equal(
        _bits(body["predictions"]), _bits(np.asarray(jax_rt.predict(dense))))


@pytest.mark.parametrize("seed", [0, 5])
def test_seeded_runtime_grows_the_jax_trees(seed):
    port = build_runtime("gbdt", 8, seed=seed, device="cpu")
    ref = jax_build_runtime("gbdt", 8, seed=seed)
    np.testing.assert_array_equal(port.gbdt.boundaries, ref.gbdt.boundaries)
    sf = np.asarray(ref.ensemble.split_feat)
    np.testing.assert_array_equal(port.ensemble.split_feat.numpy(), sf)
    np.testing.assert_array_equal(port.ensemble.split_bin.numpy()[sf >= 0],
                                  np.asarray(ref.ensemble.split_bin)[sf >= 0])
    np.testing.assert_allclose(port.ensemble.leaf_value.numpy(),
                               np.asarray(ref.ensemble.leaf_value),
                               rtol=1e-5, atol=1e-6)


# -- envelopes: the same requests to both servers -----------------------------

_FAULT_503 = {"rules": [
    {"site": "serve.predict", "kind": "error", "exception": "RuntimeError",
     "message": "killed predict worker", "times": 1},
    {"site": "serve.request", "kind": "http_status", "status": 503,
     "headers": {"retry-after": "1"},
     "body": json.dumps({"error": {"code": "overloaded",
                                   "message": "storm", "retry_after": 1}}),
     "after": 1, "times": 1}]}


def _requests(nf):
    row = [0.5] * nf
    return [
        ("/v1/score", {"instances": [row[:-1]]}),                # width
        ("/v1/score", b"{not json"),
        ("/v1/score", {"instances": []}),
        ("/v1/score", [row]),
        ("/v1/score", {"instances": [{"index": [0, nf], "value": [1, 2]}]}),
        ("/v1/score", {"instances": [{"index": [1.5], "value": [1]}]}),
        ("/v1/score", b'{"instances": [[' + b",".join([b"1e400"] * nf)
         + b"]]}"),
        ("/v1/score", {"instances": [row] * 9}),                  # > max_batch
        ("/v1/score", {"instances": ["abc"]}),
        ("/v1/score/nope", {"instances": [row]}),
        ("/v1/other", {"instances": [row]}),
    ]


def _exchange(url, nf, plan_module):
    out = [_post(url, path, body) for path, body in _requests(nf)]
    plan_module.configure(_FAULT_503)
    out.append(_post(url, "/v1/score", {"instances": [[0.5] * nf]}))
    out.append(_post(url, "/v1/score", {"instances": [[0.5] * nf]}))
    plan_module.clear()
    out.append(_get(url, "/nope"))
    status, raw = _get(url, "/healthz")
    health = json.loads(raw)
    health.pop("uptime_s")
    for adm in health["admission"].values():
        adm.pop("drain_rate_bps")
    return out, (status, health)


def test_error_envelopes_and_healthz_match_jax(tmp_path):
    jm, ens, _ = _small_pair(handle_missing=False)
    mgr = JaxManager(str(tmp_path / "m"))
    mgr.save(1, jm.serving_state(ens), async_=False)
    uri = mgr.step_uri(1)
    results = []
    for server, rt, plans in (
            (ScoringServer, build_runtime("gbdt", SMALL_NF, checkpoint=uri,
                                          device="cpu"), fault),
            (JaxServer, jax_build_runtime("gbdt", SMALL_NF, checkpoint=uri),
             jax_fault)):
        with server(rt, max_batch=8, warmup=False) as srv:
            results.append(_exchange(srv.url, SMALL_NF, plans))
    (port, port_health), (ref, ref_health) = results
    statuses = [s for s, _ in port]
    assert statuses == [400] * 9 + [404, 400, 503, 503, 400]
    assert port == ref
    assert port_health == ref_health
    assert port_health[1]["model"] == "gbdt"


def test_stats_metrics_and_not_ported_parts(tmp_path):
    runtime = build_runtime("gbdt", 4, seed=2, device="cpu")
    was_enabled = telemetry.enabled()
    telemetry.enable()
    try:
        with ScoringServer(runtime, max_batch=8) as srv:
            assert _post(srv.url, "/v1/score",
                         {"instances": [[0.1, 0.2, 0.3, 0.4]]})[0] == 200
            status, raw = _get(srv.url, "/stats")
            metrics_status, metrics = _get(srv.url, "/metrics")
    finally:
        if not was_enabled:
            telemetry.disable()
    assert status == 200
    latency = json.loads(raw)["metrics"][
        'dmlc_serve_request_seconds{model="gbdt",status="200"}']
    assert latency["count"] >= 1 and latency["p99"] > 0
    assert metrics_status == 200
    assert b"dmlc_serve_requests_total" in metrics
    assert b"dmlc_serve_warmup_total" in metrics
    for kind in ("linear", "mlp"):
        with pytest.raises(NotImplementedError, match="item 9"):
            build_runtime(kind, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="eventloop"):
        ScoringServer(runtime, transport="evloop")
    with pytest.raises(SystemExit):
        serve_main(["--model", "gbdt", "--replicas", "2", "--device", "cpu"])
    for n in (1, 5, 64, 100):
        assert batch_buckets(n) == jax_batch_buckets(n)


def test_predict_failure_fails_the_batch_and_the_sync_point():
    class Broken(ModelRuntime):
        name = "broken"

        def predict(self, x):
            raise RuntimeError("device fault")

    batcher = MicroBatcher(Broken(3), max_batch=4, max_delay_ms=1.0)
    batcher.start()
    try:
        with pytest.raises(PredictFailed, match="device fault"):
            batcher.submit(np.zeros((2, 3), np.float32)).result(10)
    finally:
        batcher.close()
    y = torch.arange(4, dtype=torch.float32)
    np.testing.assert_array_equal(to_host(PendingResult(y)), np.arange(4))
    np.testing.assert_array_equal(to_host(y), np.arange(4))


def test_serving_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        assert build_runtime("gbdt", 4).gbdt.device.type == "cuda"
        return
    runtime = build_runtime("gbdt", 4, seed=1, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, runtime.gbdt.serving_state(runtime.ensemble), async_=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_runtime("gbdt", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_runtime("gbdt", 4, checkpoint=mgr.step_uri(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GBDT.from_serving_state(load_checkpoint(mgr.step_uri(1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--model", "gbdt", "--num-feature", "4",
                    "--checkpoint", mgr.step_uri(1), "--port", "0"])


# -- hot swap and the CLI -------------------------------------------------------

def _port_fit(rows=400, rounds=3):
    rng = np.random.RandomState(4)
    x = rng.randn(rows, SMALL_NF).astype(np.float32)
    y = (x[:, 1] + x[:, 2] > 0).astype(np.float32)
    gbdt = GBDT(GBDTParam(num_boost_round=rounds, max_depth=4, num_bins=32),
                num_feature=SMALL_NF, device="cpu")
    gbdt.make_bins(x)
    bins = gbdt.bin_features(x)
    ens, _ = gbdt.fit_binned(bins, y)
    return gbdt, ens, bins, y, x


def test_watcher_hot_swap_answers_every_request_bitwise(tmp_path):
    gbdt, ens, bins, y, x = _port_fit()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=5)
    mgr.save(1, gbdt.serving_state(ens), async_=False)
    ens2, _ = gbdt.append_rounds(ens, bins, y, num_rounds=2)
    pool = x[:64]
    want = {1: GBDTRuntime(gbdt, ens).predict_float(pool),
            2: GBDTRuntime(gbdt, ens2).predict_float(pool)}
    assert not np.array_equal(want[1], want[2])
    registry = ModelRegistry()
    registry.add("champion", build_runtime("gbdt", SMALL_NF,
                                           checkpoint=mgr.step_uri(1),
                                           device="cpu"),
                 version=1, max_batch=16, max_delay_ms=1.0, default=True)
    results, stop = [], threading.Event()
    lock = threading.Lock()

    def client(seed):
        rng = np.random.RandomState(seed)
        while not stop.is_set():
            idx = rng.randint(0, 64, rng.randint(1, 9))
            status, body = _post(srv.url, "/v1/score",
                                 {"instances": pool[idx].tolist()})
            with lock:
                results.append((status, body, idx))

    with ScoringServer(registry, request_timeout_s=20.0) as srv:
        watcher = CheckpointWatcher(
            registry, "champion", mgr.directory,
            runtime_builder("gbdt", SMALL_NF, device="cpu"),
            poll_s=0.05, manager=mgr)
        with watcher:
            clients = [threading.Thread(target=client, args=(s,))
                       for s in range(4)]
            for t in clients:
                t.start()
            while len(results) < 20:
                stop.wait(0.02)
            mgr.save(2, gbdt.serving_state(ens2), async_=False)
            deadline = 400
            while registry.get("champion").version != 2 and deadline:
                stop.wait(0.05)
                deadline -= 1
            seen = len(results)
            while len(results) < seen + 20:
                stop.wait(0.02)
            stop.set()
            for t in clients:
                t.join(30)
        status, raw = _get(srv.url, "/healthz")
    assert watcher.swaps_completed == 1 and watcher.rejections == 0
    assert json.loads(raw)["version"] == 2
    versions = set()
    for status, body, idx in results:
        assert status == 200, body
        v = body["version"]
        versions.add(v)
        np.testing.assert_array_equal(_bits(body["predictions"]),
                                      _bits(want[v][idx]))
    assert versions == {1, 2}
    assert results[-1][1]["version"] == 2


def test_cli_round_trip_on_the_cpu(tmp_path):
    gbdt, ens, _, _, x = _port_fit(rounds=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, gbdt.serving_state(ens), async_=False)
    want = GBDTRuntime(gbdt, ens).predict_float(x[:3])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serve", "--model",
         "gbdt", "--checkpoint", mgr.step_uri(1), "--num-feature",
         str(SMALL_NF), "--port", "0", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving gbdt on http://"), \
            line + proc.stderr.read()
        url = line.split(" on ", 1)[1].split()[0]
        status, body = _post(url, "/v1/score", {"instances": x[:3].tolist()})
        assert status == 200 and body["version"] == 0
        np.testing.assert_array_equal(_bits(body["predictions"]),
                                      _bits(want))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "serve: shut down cleanly" in out
