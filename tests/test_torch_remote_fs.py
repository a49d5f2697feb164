"""The port's remote filesystems against the JAX package's, on the same bytes.

Each case runs the JAX package and the port over fresh, identical stores: a
strict SigV4-verifying ``MockS3`` (``tests/mock_s3.py``), the Azure double of
``tests/test_azure.py``, a small ranged HTTP server, and a
``pyarrow.fs.LocalFileSystem`` standing in for the namenode (as
``tests/test_hdfs.py`` does).  Objects, request logs, read bytes, listings,
errors, SigV4 headers, retry schedules and the ``dmlc_filesystem_*`` series
must be equal.  Payloads are made from a numpy seed.
"""

import base64
import datetime
import email.utils
import random
import threading
import types
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from dmlc_core_tpu import fault as j_fault
from dmlc_core_tpu import telemetry as j_telemetry
from dmlc_core_tpu.io import __main__ as j_cli
from dmlc_core_tpu.io import aws_sig as j_sig
from dmlc_core_tpu.io import azure_filesys as j_azure
from dmlc_core_tpu.io import filesys as j_fsys
from dmlc_core_tpu.io import hdfs_filesys as j_hdfs
from dmlc_core_tpu.io import net_retry as j_retry
from dmlc_core_tpu.io import ranged_read as j_ranged
from dmlc_core_tpu.io import s3_filesys as j_s3
from dmlc_core_tpu.io import stream as j_stream
from dmlc_core_tpu.utils import logging as j_logging
from dmlc_core_tpu_torch import fault as p_fault
from dmlc_core_tpu_torch import telemetry as p_telemetry
from dmlc_core_tpu_torch.io import __main__ as p_cli
from dmlc_core_tpu_torch.io import aws_sig as p_sig
from dmlc_core_tpu_torch.io import azure_filesys as p_azure
from dmlc_core_tpu_torch.io import filesys as p_fsys
from dmlc_core_tpu_torch.io import fs_metrics as p_fs_metrics
from dmlc_core_tpu_torch.io import hdfs_filesys as p_hdfs
from dmlc_core_tpu_torch.io import net_retry as p_retry
from dmlc_core_tpu_torch.io import ranged_read as p_ranged
from dmlc_core_tpu_torch.io import s3_filesys as p_s3
from dmlc_core_tpu_torch.io import stream as p_stream
from dmlc_core_tpu_torch.utils import logging as p_logging
from tests.mock_s3 import MockS3
from tests.test_azure import MockAzure

PKGS = {
    "jax": types.SimpleNamespace(
        fsys=j_fsys, stream=j_stream, s3=j_s3, azure=j_azure, hdfs=j_hdfs,
        ranged=j_ranged, cli=j_cli, retry=j_retry, fault=j_fault,
        telemetry=j_telemetry, Error=j_logging.Error),
    "port": types.SimpleNamespace(
        fsys=p_fsys, stream=p_stream, s3=p_s3, azure=p_azure, hdfs=p_hdfs,
        ranged=p_ranged, cli=p_cli, retry=p_retry, fault=p_fault,
        telemetry=p_telemetry, Error=p_logging.Error),
}


def _payload(n, seed=0):
    return np.random.RandomState(seed).bytes(n)


def _s3_env(monkeypatch, server):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-key")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.setenv("S3_ENDPOINT", f"http://127.0.0.1:{server.port}")


def _on_s3(monkeypatch, fn, seed_objects=None, **mock_kw):
    """Run ``fn(pkg, server)`` for each package on a fresh store holding
    ``seed_objects``; returns {package: (result, objects, requests)}."""
    out = {}
    for name, pkg in PKGS.items():
        server = MockS3(**mock_kw).start()
        server.objects.update(seed_objects or {})
        _s3_env(monkeypatch, server)
        try:
            result = fn(pkg, server)
            out[name] = (result, dict(server.objects), list(server.requests))
        finally:
            server.stop()
    return out


def _assert_same(out):
    assert out["port"] == out["jax"]
    return out["port"]


def _error_of(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        text = str(exc).split("\nStack trace:")[0]
        # drop the "[file.py:line] " prefix of the packages' fatal errors
        return type(exc).__name__, text.split("] ", 1)[-1]
    return None


# ------------------------------------------------------------------ SigV4 --

_SIG_CASES = {
    "get-empty": ("GET", "h", "/b/k", {}, {}, "e3b0c442", "s3", None,
                  "us-east-1"),
    "put-body": ("PUT", "127.0.0.1:9000", "/bucket/dir/obj.bin", {},
                 {"Content-Type": "application/octet-stream"},
                 "ab" * 32, "s3", None, "eu-west-1"),
    "list-query": ("GET", "s3.amazonaws.com", "/bucket",
                   {"list-type": "2", "prefix": "dir/with space/",
                    "delimiter": "/", "continuation-token": "k+1=/x"},
                   {}, "e3b0c442", "s3", None, "us-east-1"),
    "awkward-key": ("GET", "h", "/b/dir/unicode-é中 plus+sign=eq~ok%.txt",
                    {}, {"Range": "bytes=0-99"}, "UNSIGNED-PAYLOAD", "s3",
                    None, "us-east-1"),
    "session-token": ("HEAD", "h", "/b/k", {}, {}, "e3b0c442", "s3",
                      "token/with+chars==", "ap-south-1"),
    "multipart-part": ("PUT", "h", "/b/big.bin",
                       {"partNumber": "3", "uploadId": "upload-7"},
                       {"x-amz-meta-dmlc-write-token": "abc"}, "cd" * 32,
                       "s3", None, "us-east-1"),
    "gcs-service": ("POST", "storage.googleapis.com", "/b/k",
                    {"uploads": ""}, {}, "e3b0c442", "gs", None,
                    "us-east-1"),
    "header-spaces": ("GET", "h", "/b/k", {}, {"X-Custom": "  padded  "},
                      "e3b0c442", "s3", None, "us-east-1"),
}


@pytest.mark.parametrize("case", sorted(_SIG_CASES))
def test_sigv4_headers_byte_equal(case):
    method, host, path, query, headers, payload, service, token, region = \
        _SIG_CASES[case]
    now = datetime.datetime(2026, 3, 14, 15, 9, 26,
                            tzinfo=datetime.timezone.utc)
    got = []
    for sig in (j_sig, p_sig):
        creds = sig.Credentials("AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfi",
                                token, region)
        got.append(sig.sign_request(creds, method, host, path, dict(query),
                                    dict(headers), payload, service=service,
                                    now=now))
    assert got[0] == got[1]
    assert got[1]["Authorization"].startswith("AWS4-HMAC-SHA256 Credential=")


# -------------------------------------------------------------- net_retry --

class _Clock:
    """A fake ``time`` for net_retry: recorded sleeps that advance a
    monotonic clock, and a fixed wall clock."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps = []

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s

    def monotonic(self):
        return self.now

    def time(self):
        return 1_800_000_000.0


def _script(steps):
    """perform() replaying ``steps``: an int status, (status, headers), or
    an exception instance to raise."""
    it = iter(steps)

    def perform():
        step = next(it)
        if isinstance(step, BaseException):
            raise step
        status, headers = step if isinstance(step, tuple) else (step, {})
        return status, dict(headers), b"body-%d" % status

    return perform


_HTTP_DATE = email.utils.formatdate(1_800_000_000.0 + 3, usegmt=True)

_RETRY_CASES = {
    "storm-to-success": ([503, 503, 200], {}),
    "exhausted-status": ([503, 500, 502, 504], {}),
    "transport-then-ok": ([ConnectionResetError("x"), 200], {}),
    "transport-exhausted": ([BrokenPipeError("x")] * 4, {}),
    "not-retryable": ([404], {}),
    "retry-after-seconds": ([(503, {"Retry-After": "2.5"}), 200], {}),
    "retry-after-case": ([(429, {"RETRY-AFTER": "1.25"}), 200], {}),
    "retry-after-date": ([(503, {"Retry-After": _HTTP_DATE}), 200], {}),
    "retry-after-garbage": ([(503, {"Retry-After": "soon"}), 200], {}),
    "retry-after-capped": ([(503, {"Retry-After": "86400"}), 200], {}),
    "deadline-status": ([(503, {"Retry-After": "30"})] * 4,
                        {"DMLC_NET_RETRY_DEADLINE": "0.05"}),
    "deadline-transport": ([ConnectionResetError("x")] * 4,
                           {"DMLC_NET_RETRY_DEADLINE": "0.0001"}),
    "max-retry-env": ([503] * 7 + [200], {"S3_MAX_ERROR_RETRY": "7"}),
}


def _run_schedule(retry, monkeypatch, steps, seed, ok=(200,)):
    clock = _Clock()
    monkeypatch.setattr(retry, "time", clock)
    monkeypatch.setattr(retry, "_rng", random.Random(seed))
    try:
        result = retry.request_with_retries(_script(steps), ok, "GET /b/k")
    except Exception as exc:  # noqa: BLE001 — compared across packages
        result = type(exc).__name__
    return result, clock.sleeps


@pytest.mark.parametrize("case", sorted(_RETRY_CASES))
def test_net_retry_schedule_equal(case, monkeypatch):
    steps, env = _RETRY_CASES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for seed in (0, 1234):
        want = _run_schedule(j_retry, monkeypatch, steps, seed)
        got = _run_schedule(p_retry, monkeypatch, steps, seed)
        assert got == want
    # the jittered windows of the reference policy
    for attempt, slept in enumerate(got[1]):
        assert 0.0 <= slept <= p_retry.RETRY_AFTER_CAP


def test_net_retry_constants_equal():
    for name in ("RETRYABLE_STATUS", "BACKOFF_BASE", "BACKOFF_CAP",
                 "RETRY_AFTER_CAP"):
        assert getattr(p_retry, name) == getattr(j_retry, name)
    assert [e.__name__ for e in p_retry.RETRYABLE_EXC] == \
        [e.__name__ for e in j_retry.RETRYABLE_EXC]
    assert p_fault.SITES["net.request"] == j_fault.SITES["net.request"]


_PLANS = {
    "503-storm": {"rules": [{"site": "net.request", "kind": "http_status",
                             "status": 503, "times": 2}]},
    "reset-once": {"rules": [{"site": "net.request", "kind": "reset",
                              "times": 1}]},
    "always-500": {"rules": [{"site": "net.request", "kind": "http_status",
                              "status": 500, "times": None}]},
}


@pytest.mark.parametrize("plan", sorted(_PLANS))
def test_net_request_fault_plans_equal(plan, monkeypatch):
    """An injected ``net.request`` plan gives the same outcome, retry
    schedule and fire log in both packages, over the strict store."""
    data = _payload(3000, seed=5)

    def run(pkg, server):
        clock = _Clock()
        monkeypatch.setattr(pkg.retry, "time", clock)
        monkeypatch.setattr(pkg.retry, "_rng", random.Random(9))
        pkg.fault.configure(_PLANS[plan])
        try:
            err = _error_of(lambda: pkg.stream.create_stream_for_read(
                "s3://bucket/obj.bin").read(len(data)))
            fires = [(site, kind) for site, kind, _ in pkg.fault.fires()]
        finally:
            pkg.fault.clear()
        return err, clock.sleeps, fires

    out = _on_s3(monkeypatch, run, {("bucket", "obj.bin"): data})
    (err, sleeps, fires), _, _ = _assert_same(out)
    assert fires and sleeps
    if plan == "always-500":
        assert err is not None and "500" in err[1]
    else:
        assert err is None


# ------------------------------------------------------------------ S3/GCS --

@pytest.mark.parametrize("nbytes", [0, 1, 4095, 70_000])
def test_s3_single_put_roundtrip(monkeypatch, nbytes):
    data = _payload(nbytes, seed=nbytes)

    def run(pkg, server):
        with pkg.stream.create_stream("s3://bucket/dir/obj.bin", "w") as s:
            s.write(data[:nbytes // 2])
            s.write(data[nbytes // 2:])
        with pkg.stream.create_stream_for_read("s3://bucket/dir/obj.bin") as s:
            return s.read(nbytes + 10)

    got, objects, requests = _assert_same(_on_s3(monkeypatch, run))
    assert got == data == objects[("bucket", "dir/obj.bin")]
    assert [m for m, _ in requests].count("PUT") == 1


@pytest.mark.parametrize("mb,slices", [(5, (3, 5, 1, 3)), (6, (13,))])
def test_s3_multipart_upload(monkeypatch, mb, slices):
    """Multipart at ``DMLC_S3_WRITE_BUFFER_MB``: the same parts, the same
    request sequence and the same multipart ETag as the JAX writer."""
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_MB", str(mb))
    data = _payload(sum(slices) << 20, seed=mb)

    def run(pkg, server):
        pos = 0
        with pkg.stream.create_stream("s3://bucket/big.bin", "w") as s:
            for sz in slices:
                s.write(data[pos:pos + (sz << 20)])
                pos += sz << 20
        return server.etags[("bucket", "big.bin")]

    etag, objects, requests = _assert_same(_on_s3(monkeypatch, run))
    assert objects[("bucket", "big.bin")] == data
    nparts = -(-len(data) // (mb << 20))
    assert etag.endswith(f"-{nparts}")
    assert sum(1 for m, p in requests if m == "PUT" and "partNumber" in p) \
        == nparts


def test_s3_write_abort_leaves_nothing(monkeypatch):
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_MB", "5")
    data = _payload(6 << 20, seed=3)

    def run(pkg, server):
        fo = pkg.stream.create_stream("s3://bucket/aborted.bin", "w")
        fo.write(data)
        fo.abort()
        fo.close()
        return sorted(server.uploads)

    uploads, objects, requests = _assert_same(_on_s3(monkeypatch, run))
    assert uploads == [] and ("bucket", "aborted.bin") not in objects
    assert requests[-1][0] == "DELETE"


_READS = [(1000, 10), (0, 5), (25_000, 200), (0, 0), (60_000, 10_000),
          (65_535, 5)]


@pytest.mark.parametrize("buffer_bytes", [64, 4 << 20])
def test_s3_ranged_reads_and_seeks(monkeypatch, buffer_bytes):
    data = _payload(65_536, seed=1)

    def run(pkg, server):
        fo = pkg.stream.create_stream_for_read("s3://bucket/blob.bin")
        fo._buffer_bytes = buffer_bytes
        got = []
        for pos, n in _READS:
            fo.seek(pos)
            got.append((fo.read(n), fo.tell()))
        return got

    got, _, requests = _assert_same(
        _on_s3(monkeypatch, run, {("bucket", "blob.bin"): data}))
    for (pos, n), (chunk, tell) in zip(_READS, got):
        assert chunk == data[pos:pos + n] and tell == pos + len(chunk)
    assert sum(1 for m, _ in requests if m == "GET") >= 2


_AWKWARD = ["dir/with space.txt", "dir/plus+sign.txt", "dir/eq=uals.txt",
            "dir/unicode-é中.txt", "dir/tilde~ok.txt", "dir/pct%41.txt",
            "dir/sub dir/a b+c.txt"]


def test_s3_awkward_keys_write_stat_read_list(monkeypatch):
    def run(pkg, server):
        fs = pkg.s3.S3FileSystem()
        for i, key in enumerate(_AWKWARD):
            with pkg.stream.create_stream(f"s3://bucket/{key}", "w") as s:
                s.write(b"payload-%d" % i)
        reads = []
        for key in _AWKWARD:
            with pkg.stream.create_stream_for_read(f"s3://bucket/{key}") as s:
                reads.append(s.read(64))
        infos = [(i.size, i.type.name)
                 for i in (fs.get_path_info(pkg.fsys.URI(f"s3://bucket/{k}"))
                           for k in _AWKWARD)]
        listed = sorted((e.path.name, e.size, e.type.name) for e in
                        fs.list_directory(pkg.fsys.URI("s3://bucket/dir")))
        return reads, infos, listed

    (reads, infos, listed), objects, _ = _assert_same(_on_s3(monkeypatch, run))
    assert reads == [b"payload-%d" % i for i in range(len(_AWKWARD))]
    assert {k for _, k in objects} == set(_AWKWARD)
    assert ("/dir/sub dir", 0, "DIRECTORY") in listed


@pytest.mark.parametrize("page_size,nkeys", [(7, 23), (1000, 1203)])
def test_s3_paginated_listing(monkeypatch, page_size, nkeys):
    """ListObjectsV2 pages (past 1,000 keys too): every page followed, the
    common prefix once."""
    seed = {("bucket", f"many/k{i:05d}.txt"): b"x" * (i % 13)
            for i in range(nkeys)}
    seed[("bucket", "many/sub/inner.txt")] = b"y"

    def run(pkg, server):
        fs = pkg.s3.S3FileSystem()
        return [(e.path.name, e.size, e.type.name) for e in
                fs.list_directory(pkg.fsys.URI("s3://bucket/many"))]

    listed, _, requests = _assert_same(
        _on_s3(monkeypatch, run, seed, page_size=page_size))
    names = [n for n, _, _ in listed]
    assert sorted(names) == sorted([f"/many/k{i:05d}.txt"
                                    for i in range(nkeys)] + ["/many/sub"])
    assert names.count("/many/sub") == 1
    assert sum(1 for m, p in requests if "list-type" in p) == \
        -(-nkeys // page_size)


def test_s3_path_info_directory_and_missing(monkeypatch):
    seed = {("bucket", "data/a.txt"): b"aaa", ("bucket", "data/sub/c"): b"c"}

    def run(pkg, server):
        fs = pkg.s3.S3FileSystem()
        f = fs.get_path_info(pkg.fsys.URI("s3://bucket/data/a.txt"))
        d = fs.get_path_info(pkg.fsys.URI("s3://bucket/data"))
        missing = _error_of(lambda: fs.get_path_info(
            pkg.fsys.URI("s3://bucket/missing-zone")))
        read_missing = _error_of(lambda: pkg.stream.create_stream_for_read(
            "s3://bucket/nope.bin"))
        return (f.size, f.type.name), (d.size, d.type.name), missing, \
            read_missing

    (f, d, missing, read_missing), _, _ = _assert_same(
        _on_s3(monkeypatch, run, seed))
    assert f == (3, "FILE")
    assert d == (0, "DIRECTORY")
    assert missing == ("FileNotFoundError", "s3://bucket/missing-zone")
    assert read_missing[0] == "FileNotFoundError"


def test_s3_append_mode_refused_and_credentials_required(monkeypatch):
    def run(pkg, server):
        append = _error_of(lambda: pkg.stream.create_stream(
            "s3://bucket/x", "a"))
        monkeypatch.delenv("AWS_ACCESS_KEY_ID")
        creds = _error_of(lambda: pkg.stream.create_stream(
            "s3://bucket/x", "r"))
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-key")
        return append, creds

    (append, creds), _, _ = _assert_same(_on_s3(monkeypatch, run))
    assert "append" in append[1]
    assert "ACCESS_KEY" in creds[1]


def test_s3_strict_mock_rejects_wrong_secret(monkeypatch):
    def run(pkg, server):
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "WRONG")
        return _error_of(lambda: pkg.stream.create_stream_for_read(
            "s3://bucket/x.txt").read(4))

    err, _, _ = _assert_same(_on_s3(
        monkeypatch, run, {("bucket", "x.txt"): b"data"},
        secrets=["the-real-secret"]))
    assert "403" in err[1]


def test_gcs_interop_roundtrip(monkeypatch):
    monkeypatch.setenv("GCS_ACCESS_KEY_ID", "gcs-key")
    monkeypatch.setenv("GCS_SECRET_ACCESS_KEY", "gcs-secret")
    data = _payload(5000, seed=8)

    def run(pkg, server):
        with pkg.stream.create_stream("gs://bucket/obj.bin", "w") as s:
            s.write(data)
        with pkg.stream.create_stream_for_read("gs://bucket/obj.bin") as s:
            return s.read(10_000)

    got, objects, _ = _assert_same(_on_s3(monkeypatch, run))
    assert got == data == objects[("bucket", "obj.bin")]


def test_s3_reads_survive_mid_body_drops(monkeypatch):
    """A store that cuts every 3rd GET mid-body: the retried reads come
    back byte-equal, with the same request log."""
    data = _payload(300_000, seed=4)

    def run(pkg, server):
        monkeypatch.setattr(pkg.retry, "time", _Clock())
        fo = pkg.stream.create_stream_for_read("s3://bucket/flaky.bin")
        fo._buffer_bytes = 50_000
        chunks = [fo.read(10_000) for _ in range(len(data) // 10_000 + 1)]
        return b"".join(chunks), server.injected_failures

    (got, failures), _, _ = _assert_same(
        _on_s3(monkeypatch, run, {("bucket", "flaky.bin"): data},
               fail_every=3))
    assert got == data and failures >= 1


def _series(telemetry, prefix):
    """The ``prefix*`` series of a package's registry: counter values and
    histogram sample counts (not their sums, which are times)."""
    out = {}
    for name, metric in telemetry.snapshot()["metrics"].items():
        if not name.startswith(prefix):
            continue
        for sample in metric["samples"]:
            key = (name, tuple(sorted(sample["labels"].items())))
            out[key] = sample.get("count", sample.get("value"))
    return out


def test_filesystem_series_equal(monkeypatch):
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_MB", "5")
    data = _payload(6 << 20, seed=11)

    def run(pkg, server):
        was = pkg.telemetry.enabled()
        pkg.telemetry.enable()
        pkg.telemetry.reset()
        try:
            with pkg.stream.create_stream("s3://bucket/m.bin", "w") as s:
                s.write(data)
            with pkg.stream.create_stream_for_read("s3://bucket/m.bin") as s:
                s.read(len(data))
            return _series(pkg.telemetry, "dmlc_filesystem_")
        finally:
            pkg.telemetry.reset()
            if not was:
                pkg.telemetry.disable()

    series, _, _ = _assert_same(_on_s3(monkeypatch, run))
    # request and response bodies of every round trip: the data plus the
    # multipart XML
    assert series[("dmlc_filesystem_write_bytes_total",
                   (("fs", "s3"),))] >= len(data)
    assert series[("dmlc_filesystem_read_bytes_total",
                   (("fs", "s3"),))] >= len(data)
    assert ("dmlc_filesystem_request_seconds",
            (("fs", "s3"), ("op", "POST"))) in series
    assert p_fs_metrics.request_start() == 0.0 or p_telemetry.enabled()


# ------------------------------------------------------ RangedReadFile --

def test_ranged_read_file_over_s3(monkeypatch):
    data = _payload(100_000, seed=12)
    ops = [("seek", 0, 0), ("read", 10), ("seek", -24, 2), ("read", -1),
           ("seek", 5, 0), ("seek", 100, 1), ("read", 50), ("tell",),
           ("seek", 200_000, 0), ("read", 10)]

    def run(pkg, server):
        out = []
        with pkg.ranged.RangedReadFile("s3://bucket/r.bin") as f:
            out.append(f.size())
            for op in ops:
                if op[0] == "read":
                    out.append(f.read(op[1]))
                elif op[0] == "seek":
                    out.append(f.seek(op[1], op[2]))
                else:
                    out.append(f.tell())
        out.append(f.closed)
        return out

    got, _, _ = _assert_same(
        _on_s3(monkeypatch, run, {("bucket", "r.bin"): data}))
    assert got[0] == len(data) and got[2] == data[:10]
    assert got[4] == data[-24:] and got[7] == data[105:155]
    assert got[-2] == b"" and got[-1] is True


# ------------------------------------------------------------------ Azure --

def _on_azure(monkeypatch, fn, seed_blobs=None):
    out = {}
    for name, pkg in PKGS.items():
        server = MockAzure().start()
        server.blobs.update(seed_blobs or {})
        monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "testacct")
        monkeypatch.setenv("AZURE_STORAGE_ACCESS_KEY",
                           base64.b64encode(b"secret-key").decode())
        monkeypatch.setenv("AZURE_ENDPOINT", f"http://127.0.0.1:{server.port}")
        try:
            out[name] = (fn(pkg, server), dict(server.blobs))
        finally:
            server.stop()
    return out


@pytest.mark.parametrize("nbytes,buffer_mb", [(11, None), (4 << 20, "1")])
def test_azure_roundtrip_and_block_upload(monkeypatch, nbytes, buffer_mb):
    if buffer_mb:
        monkeypatch.setenv("DMLC_AZURE_WRITE_BUFFER_MB", buffer_mb)
    data = _payload(nbytes, seed=nbytes % 97)

    def run(pkg, server):
        with pkg.stream.create_stream("azure://cont/dir/x.bin", "w") as s:
            s.write(data)
        with pkg.stream.create_stream_for_read("azure://cont/dir/x.bin") as s:
            return s.read(nbytes + 1)

    got, blobs = _assert_same(_on_azure(monkeypatch, run))
    assert got == data == blobs[("cont", "dir/x.bin")]


def test_azure_seek_listing_missing_and_drops(monkeypatch):
    data = _payload(20_000, seed=13)
    seed = {("cont", "d/a"): b"1", ("cont", "d/b"): b"22",
            ("cont", "d/sub/c"): b"3", ("cont", "blob.bin"): data}

    def run(pkg, server):
        fo = pkg.stream.create_stream_for_read("azure://cont/blob.bin")
        fo.seek(300)
        part = fo.read(10)
        fs = pkg.azure.AzureFileSystem()
        listed = sorted((e.path.name, e.size, e.type.name) for e in
                        fs.list_directory(pkg.fsys.URI("azure://cont/d")))
        size = fs.get_path_info(pkg.fsys.URI("azure://cont/d/b")).size
        missing = _error_of(lambda: fs.get_path_info(
            pkg.fsys.URI("azure://cont/none")))
        monkeypatch.setattr(pkg.retry, "time", _Clock())
        server.drop_next_get = 2
        whole = pkg.stream.create_stream_for_read(
            "azure://cont/blob.bin").read(len(data))
        return part, listed, size, missing, whole, server.drop_next_get

    (part, listed, size, missing, whole, left), _ = _assert_same(
        _on_azure(monkeypatch, run, seed))
    assert part == data[300:310] and size == 2 and whole == data
    assert left == 0 and missing[0] == "FileNotFoundError"
    assert ("/d/sub", 0, "DIRECTORY") in listed


# ------------------------------------------------------------------- HTTP --

class _HTTPStore:
    """Read-only ranged HTTP server over a dict of paths."""

    def __init__(self, ranges=True):
        self.files = {}
        self.ranges = ranges
        self.requests = []

    def start(self):
        store = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _head(self, status, length):
                self.send_response(status)
                self.send_header("Content-Length", str(length))
                if store.ranges:
                    self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_HEAD(self):
                store.requests.append(("HEAD", self.path, None))
                data = store.files.get(urllib.parse.unquote(self.path))
                self._head(404 if data is None else 200,
                           0 if data is None else len(data))

            def do_GET(self):
                rng = self.headers.get("Range")
                store.requests.append(("GET", self.path, rng))
                data = store.files.get(urllib.parse.unquote(self.path))
                if data is None:
                    self._head(404, 0)
                    return
                if rng and store.ranges:
                    start, end = rng.split("=")[1].split("-")
                    piece = data[int(start):int(end) + 1]
                    self._head(206, len(piece))
                    self.wfile.write(piece)
                    return
                self._head(200, len(data))
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("ranges", [True, False])
def test_http_reads_seeks_and_errors(ranges):
    data = _payload(50_000, seed=14)
    out = {}
    for name, pkg in PKGS.items():
        server = _HTTPStore(ranges).start()
        server.files["/files/a.bin"] = data
        base = f"http://127.0.0.1:{server.port}"
        try:
            fo = pkg.stream.create_stream_for_read(f"{base}/files/a.bin")
            fo._buffer_bytes = 4096
            reads = []
            for pos, n in ((0, 100), (40_000, 5000), (49_990, 100)):
                fo.seek(pos)
                reads.append(fo.read(n))
            info = pkg.fsys.get_filesystem(pkg.fsys.URI(base)).get_path_info(
                pkg.fsys.URI(f"{base}/files/a.bin"))
            missing = _error_of(lambda: pkg.stream.create_stream_for_read(
                f"{base}/files/none"))
            write = _error_of(lambda: pkg.stream.create_stream(
                f"{base}/files/a.bin", "w"))
            out[name] = (reads, info.size, missing[0],
                         write[1].split("] ")[-1],
                         [(m, r) for m, _, r in server.requests])
        finally:
            server.stop()
    assert out["port"] == out["jax"]
    reads = out["port"][0]
    assert reads == [data[:100], data[40_000:45_000], data[49_990:]]
    assert out["port"][1:3] == (len(data), "FileNotFoundError")


# ------------------------------------------------------------------- HDFS --

@pytest.fixture()
def hdfs_root(tmp_path, monkeypatch):
    """``hdfs://namenode:9000<abs path>`` routed to ``pyarrow``'s local
    filesystem in both packages (the reference's test double)."""
    pafs = pytest.importorskip("pyarrow.fs")
    local = pafs.LocalFileSystem()
    for mod in (j_hdfs, p_hdfs):
        monkeypatch.setattr(mod, "_arrow_fs", lambda uri: local)
    return tmp_path, lambda rel: f"hdfs://namenode:9000{tmp_path}/{rel}"


def test_hdfs_write_read_seek_append(hdfs_root):
    tmp_path, u = hdfs_root
    data = _payload(20_000, seed=15)
    got = {}
    for name, pkg in PKGS.items():
        path = u(f"{name}.bin")
        with pkg.stream.create_stream(path, "w") as fo:
            fo.write(data)
        with pkg.stream.create_stream(path, "a") as fo:
            fo.write(b"tail")
        fi = pkg.stream.create_stream_for_read(path)
        head = fi.read(5), fi.tell()
        fi.seek(len(data) - 7)
        tail = fi.read(100)
        fi.close()
        got[name] = (head, tail, (tmp_path / f"{name}.bin").read_bytes())
    assert got["port"] == got["jax"]
    assert got["port"][2] == data + b"tail"


def test_hdfs_path_info_listing_missing(hdfs_root):
    tmp_path, u = hdfs_root
    (tmp_path / "d" / "sub").mkdir(parents=True)
    (tmp_path / "d" / "a.txt").write_bytes(b"aaa")
    (tmp_path / "d" / "sub" / "b.txt").write_bytes(b"bb")
    got = {}
    for name, pkg in PKGS.items():
        fs = pkg.hdfs.HDFSFileSystem()
        info = fs.get_path_info(pkg.fsys.URI(u("d/a.txt")))
        dinfo = fs.get_path_info(pkg.fsys.URI(u("d")))
        listed = sorted((e.path.name, e.size, e.type.name) for e in
                        fs.list_directory(pkg.fsys.URI(u("d"))))
        missing = _error_of(lambda: fs.get_path_info(
            pkg.fsys.URI(u("none"))))
        got[name] = ((info.size, info.type.name), dinfo.type.name, listed,
                     missing[0])
    assert got["port"] == got["jax"]
    assert got["port"][0] == (3, "FILE")


def test_hdfs_gate_message_without_pyarrow(monkeypatch):
    """Without ``pyarrow`` (as on a machine that lacks it), ``hdfs://``
    raises the reference's gate message at use, never at import."""
    import builtins

    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError("No module named 'pyarrow'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    errs = []
    for pkg in PKGS.values():
        fs = pkg.fsys.get_filesystem(pkg.fsys.URI("hdfs://namenode/x"))
        errs.append(_error_of(lambda: fs.open_for_read(
            pkg.fsys.URI("hdfs://namenode/x"))))
    assert errs[0] == errs[1]
    assert "pyarrow" in errs[1][1]


# -------------------------------------------------------------------- CLI --

def _cli(pkg, argv, capsysbinary):
    rc = pkg.cli.main(argv)
    captured = capsysbinary.readouterr()
    return rc, captured.out, captured.err


def test_cli_ls_cat_cp_over_s3(monkeypatch, tmp_path, capsysbinary):
    data = _payload(9000, seed=16)
    seed = {("bucket", "d/a.bin"): data, ("bucket", "d/b.txt"): b"bbb",
            ("bucket", "d/sub/c"): b"c"}

    def run(pkg, server):
        local = tmp_path / f"copy-{pkg is PKGS['port']}.bin"
        results = [
            _cli(pkg, ["ls", "s3://bucket/d"], capsysbinary),
            _cli(pkg, ["cat", "s3://bucket/d/a.bin"], capsysbinary),
            _cli(pkg, ["cp", "s3://bucket/d/a.bin", str(local)],
                 capsysbinary)[0],
            _cli(pkg, ["cp", str(local), "s3://bucket/d/back.bin"],
                 capsysbinary)[0],
            _cli(pkg, ["cat", "s3://bucket/d/none"], capsysbinary)[0],
            _cli(pkg, ["frobnicate", "x"], capsysbinary)[0],
        ]
        return results, local.read_bytes()

    (results, copied), objects, requests = _assert_same(
        _on_s3(monkeypatch, run, seed))
    (ls_rc, ls_out, _), (cat_rc, cat_out, cat_err) = results[:2]
    assert ls_rc == 0 and b"s3://bucket/d/a.bin" in ls_out
    assert cat_rc == 0 and cat_out == data and b"9000 bytes" in cat_err
    assert results[2:] == [0, 0, 1, 2]
    assert copied == data == objects[("bucket", "d/back.bin")]


def test_cli_cp_and_cat_azure(monkeypatch, tmp_path, capsysbinary):
    data = _payload(3000, seed=17)

    def run(pkg, server):
        src = tmp_path / "src.bin"
        src.write_bytes(data)
        cp = _cli(pkg, ["cp", str(src), "azure://cont/x.bin"], capsysbinary)
        cat = _cli(pkg, ["cat", "azure://cont/x.bin"], capsysbinary)
        return cp[0], cat[:2]

    got, blobs = _assert_same(_on_azure(monkeypatch, run))
    assert got == (0, (0, data)) and blobs[("cont", "x.bin")] == data


def test_cli_module_invocation(tmp_path):
    import subprocess
    import sys

    (tmp_path / "a.txt").write_bytes(b"hello")
    outs = []
    for mod in ("dmlc_core_tpu.io", "dmlc_core_tpu_torch.io"):
        proc = subprocess.run([sys.executable, "-m", mod, "cat",
                               str(tmp_path / "a.txt")],
                              capture_output=True, timeout=120,
                              env={"JAX_PLATFORMS": "cpu",
                                   "PATH": "/usr/bin:/bin",
                                   "PYTHONPATH": str(
                                       __import__("pathlib").Path(
                                           __file__).parents[1])})
        outs.append((proc.returncode, proc.stdout))
    assert outs[0] == outs[1] == (0, b"hello")


# ------------------------------------------------------------ the copies --

_COPIES = ["io/fs_metrics.py", "io/aws_sig.py", "io/net_retry.py",
           "io/s3_filesys.py", "io/http_filesys.py", "io/azure_filesys.py",
           "io/hdfs_filesys.py", "io/ranged_read.py", "io/__main__.py",
           "data/page_cache.py", "data/iterators.py"]


def _code_of(path, package):
    """The module's AST without its docstring, the package name made the
    JAX package's (comments and formatting do not count)."""
    import ast

    src = open(path, encoding="utf-8").read().replace(package,
                                                      "dmlc_core_tpu")
    tree = ast.parse(src)
    if isinstance(tree.body[0], ast.Expr) and isinstance(
            tree.body[0].value, ast.Constant):
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", _COPIES)
def test_ported_module_is_a_copy_of_the_jax_package(rel):
    import pathlib

    root = pathlib.Path(__file__).parents[1]
    assert _code_of(root / "dmlc_core_tpu_torch" / rel,
                    "dmlc_core_tpu_torch") == \
        _code_of(root / "dmlc_core_tpu" / rel, "dmlc_core_tpu")
