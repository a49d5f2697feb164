"""The port's splits over an object store, against the JAX package's.

Text, recordio and indexed-recordio files (made from numpy seeds) sit in a
strict ``MockS3``.  The port reads them in 1-5 parts through its Python
split engine (the default for remote URIs) and through its native engine
(``DMLC_TPU_NATIVE_REMOTE=1``: byte reads through the read-at callback,
ring 8, batched pop); the JAX package reads them through its Python engine,
which needs no native library.  Records must be equal, disjoint and
exhaustive; ``#cachefile`` replays, shuffled orders and the shuffle
decorator equal the JAX package's.  A failed remote read re-raises the
adapter's exception, and closing a split in the middle of an epoch joins the
read-ahead thread at once.
"""

import ctypes
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from dmlc_core_tpu.data import factory as jfactory
from dmlc_core_tpu.data.row_block import concat_blocks as jconcat
from dmlc_core_tpu.io import input_split as jsplit
from dmlc_core_tpu_torch import native_bridge as nb
from dmlc_core_tpu_torch.data import factory as pfactory
from dmlc_core_tpu_torch.data.row_block import concat_blocks as pconcat
from dmlc_core_tpu_torch.io import filesys as pfs
from dmlc_core_tpu_torch.io import input_split as psplit
from tests.mock_s3 import MockS3
from tests.test_torch_input_split import (indexed_file, read_all, rec_files,
                                          text_files)
from tests.test_torch_native import (assert_bitwise,  # noqa: F401
                                     jax_python_engine, make_libsvm,
                                     merged_columns)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ("native", "python")


@pytest.fixture
def store(monkeypatch, jax_python_engine):  # noqa: F811
    server = MockS3().start()
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-key")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.setenv("S3_ENDPOINT", f"http://127.0.0.1:{server.port}")
    for key in ("DMLC_TPU_NATIVE_REMOTE", "DMLC_TPU_DISABLE_NATIVE",
                "DMLC_NATIVE_RING"):
        monkeypatch.delenv(key, raising=False)
    yield server
    server.stop()


def upload(store, local_uri, prefix="ds"):
    """Put each ';'-separated local file into the bucket; the s3 URI."""
    uris = []
    for path in local_uri.split(";"):
        key = f"{prefix}/{os.path.basename(path)}"
        with open(path, "rb") as f:
            store.objects[("bucket", key)] = f.read()
        uris.append(f"s3://bucket/{key}")
    return ";".join(uris)


def use(monkeypatch, engine):
    """Ask for one of the port's engines on remote URIs; counts set to 0."""
    if engine == "native":
        monkeypatch.setenv("DMLC_TPU_NATIVE_REMOTE", "1")
    else:
        monkeypatch.delenv("DMLC_TPU_NATIVE_REMOTE", raising=False)
    nb.reset_engine_calls()


PORT_CLASS = {"native": psplit.NativeLineSplitter,
              "python": psplit.ThreadedInputSplit}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 5])
def test_text_parts_over_bucket(tmp_path, store, monkeypatch, nparts,
                                engine):
    local, lines = text_files(tmp_path)
    uri = upload(store, local)
    use(monkeypatch, engine)
    every = []
    for part in range(nparts):
        split = psplit.create_input_split(uri, part, nparts, "text")
        assert isinstance(split, PORT_CLASS[engine])
        if engine == "native":
            assert split._adapter is not None and split._native._ring == 8
        got = read_all(split)
        assert got == read_all(jsplit.create_input_split(uri, part, nparts,
                                                         "text"))
        every += got
    assert every == lines            # disjoint and exhaustive, in order
    assert (nb.ENGINE_CALLS["lsplit_next_chunk"] > 0) == (engine == "native")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 5])
def test_recordio_parts_over_bucket(tmp_path, store, monkeypatch, nparts,
                                    engine):
    local, records = rec_files(tmp_path)
    uri = upload(store, local)
    use(monkeypatch, engine)
    every = []
    for part in range(nparts):
        split = psplit.create_input_split(uri, part, nparts, "recordio")
        assert isinstance(split, PORT_CLASS[engine])
        got = read_all(split)
        assert got == read_all(jsplit.create_input_split(uri, part, nparts,
                                                         "recordio"))
        every += got
    assert every == records
    assert (nb.ENGINE_CALLS["lsplit_next_chunk"] > 0) == (engine == "native")


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("nparts", [1, 3, 5])
def test_indexed_parts_over_bucket(tmp_path, store, monkeypatch, nparts,
                                   engine, shuffle):
    rec, idx, records = indexed_file(tmp_path)
    rec_uri, idx_uri = upload(store, rec), upload(store, idx)
    use(monkeypatch, engine)
    kw = dict(index_uri=idx_uri, shuffle=shuffle, seed=3, batch_size=7)
    every = []
    for part in range(nparts):
        split = psplit.create_input_split(rec_uri, part, nparts,
                                          "indexed_recordio", **kw)
        base = getattr(split, "_base", split)
        assert (base._span_adapter is not None) == (engine == "native")
        got = read_all(split)
        assert got == read_all(jsplit.create_input_split(
            rec_uri, part, nparts, "indexed_recordio", **kw))
        every += got
    assert sorted(every) == sorted(records)
    if not shuffle:
        assert every == records
    assert (nb.ENGINE_CALLS["span_next_chunk"] > 0) == (engine == "native")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt", ["text", "recordio", "indexed_recordio"])
def test_cachefile_over_bucket(tmp_path, store, monkeypatch, fmt, engine):
    """A remote source with a local ``#cachefile``: epoch 1 reads the
    bucket (and tees), later epochs replay the local cache."""
    if fmt == "text":
        local, want = text_files(tmp_path)
        kw = {}
    elif fmt == "recordio":
        local, want = rec_files(tmp_path)
        kw = {}
    else:
        local, idx, want = indexed_file(tmp_path)
        kw = dict(index_uri=upload(store, idx), batch_size=9)
    uri = upload(store, local)
    use(monkeypatch, engine)
    cache = tmp_path / "split.cache"
    split = psplit.create_input_split(f"{uri}#{cache}", 0, 1, fmt, **kw)
    native_cached = engine == "native" and fmt != "indexed_recordio"
    assert isinstance(split, psplit.NativeCachedSplitter if native_cached
                      else psplit.CachedInputSplit)
    first = read_all(split, close=False)
    gets = len(store.requests)
    split.before_first()
    second = read_all(split, close=False)
    split.before_first()
    third = read_all(split)
    assert first == second == third == want
    assert len(store.requests) == gets      # replays touch no bucket
    assert first == read_all(jsplit.create_input_split(
        f"{uri}#{tmp_path / 'jax.cache'}", 0, 1, fmt, **kw))
    assert cache.read_bytes() == (tmp_path / "jax.cache").read_bytes()
    if native_cached:
        assert nb.ENGINE_CALLS["creplay_next_chunk"] > 0


def test_shuffled_epochs_over_bucket_match_jax(tmp_path, store, monkeypatch):
    rec, idx, records = indexed_file(tmp_path)
    kw = dict(index_uri=upload(store, idx), shuffle=True, seed=11,
              batch_size=16)
    rec_uri = upload(store, rec)
    orders = {}
    for engine in ENGINES + ("jax",):
        if engine == "jax":
            split = jsplit.create_input_split(rec_uri, 0, 1,
                                              "indexed_recordio", **kw)
        else:
            use(monkeypatch, engine)
            split = psplit.create_input_split(rec_uri, 0, 1,
                                              "indexed_recordio", **kw)
        first = read_all(split, close=False)
        split.before_first()
        orders[engine] = (first, read_all(split))
    assert orders["native"] == orders["python"] == orders["jax"]
    first, second = orders["native"]
    assert sorted(first) == sorted(second) == sorted(records)
    assert first != second


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt,nparts,nshuffle",
                         [("text", 1, 4), ("text", 2, 3), ("recordio", 2, 2)])
def test_shuffle_decorator_over_bucket(tmp_path, store, monkeypatch, fmt,
                                       nparts, nshuffle, engine):
    local, want = (text_files if fmt == "text" else rec_files)(tmp_path)
    uri = upload(store, local)
    use(monkeypatch, engine)
    every = []
    for part in range(nparts):
        port = psplit.InputSplitShuffle(uri, part, nparts, fmt, nshuffle,
                                        shuffle_seed=5)
        jax = jsplit.InputSplitShuffle(uri, part, nparts, fmt, nshuffle,
                                       shuffle_seed=5)
        for epoch in range(2):
            if epoch:
                port.before_first()
                jax.before_first()
            got = read_all(port, close=False)
            assert got == read_all(jax, close=False)
            if epoch == 0:
                every += got
        port.close()
        jax.close()
    assert sorted(every) == sorted(want)
    assert (nb.ENGINE_CALLS["lsplit_next_chunk"] > 0) == (engine == "native")


@pytest.mark.parametrize("engine", ENGINES)
def test_parser_over_bucket_bitwise_jax(tmp_path, store, monkeypatch,
                                        engine):
    data = make_libsvm(n=3000, seed=21)
    store.objects[("bucket", "train.libsvm")] = data
    use(monkeypatch, engine)
    parser = pfactory.create_parser("s3://bucket/train.libsvm")
    got = merged_columns(list(parser), pconcat)
    parser.close()
    parser = jfactory.create_parser("s3://bucket/train.libsvm")
    want = merged_columns(list(parser), jconcat)
    parser.close()
    for name in want:
        assert_bitwise(got[name], want[name], name)
    assert (nb.ENGINE_CALLS["lsplit_next_chunk"] > 0) == (engine == "native")
    assert nb.ENGINE_CALLS["parse_libsvm"] > 0


def test_remote_default_is_python_and_env_is_read_on_each_call(store,
                                                               monkeypatch):
    store.objects[("bucket", "f/x.txt")] = b"a\nb\n"
    uri = "s3://bucket/f/x.txt"
    for value, native in ((None, False), ("0", False), ("1", True),
                          (None, False), ("yes", False), ("1", True)):
        if value is None:
            monkeypatch.delenv("DMLC_TPU_NATIVE_REMOTE", raising=False)
        else:
            monkeypatch.setenv("DMLC_TPU_NATIVE_REMOTE", value)
        split = psplit.create_input_split(uri, 0, 1, "text")
        assert isinstance(split, psplit.NativeLineSplitter) == native
        assert read_all(split) == [b"a", b"b"]
    # local files keep the native engine without the flag
    monkeypatch.delenv("DMLC_TPU_NATIVE_REMOTE")
    assert psplit._native_ring(None) == 2


def test_native_ring_depths_and_override(store, monkeypatch):
    fs = pfs.get_filesystem(pfs.URI("s3://bucket/x"))
    adapter = psplit._ReadAtAdapter(fs, [])
    assert psplit._native_ring(None) == 2
    assert psplit._native_ring(adapter) == 8
    monkeypatch.setenv("DMLC_NATIVE_RING", "16")
    assert psplit._native_ring(None) == psplit._native_ring(adapter) == 16
    monkeypatch.setenv("DMLC_NATIVE_RING", "1")
    assert psplit._native_ring(adapter) == 2


@pytest.mark.parametrize("ring", [2, 3, 8, 16])
def test_batched_pop_yields_the_object_bytes(store, ring):
    """Every ring depth (batched ``next_chunks`` pop above 2) hands back
    the object's bytes, chunk by chunk, through the read-at callback."""
    blob = make_libsvm(n=4000, seed=ring)
    store.objects[("bucket", "r.txt")] = blob
    fs = pfs.get_filesystem(pfs.URI("s3://bucket/r.txt"))
    files = psplit._expand_input_files(fs, "s3://bucket/r.txt")
    adapter = psplit._ReadAtAdapter(fs, files)
    native = nb.NativeLineSplit([f.path.name for f in files], [len(blob)],
                                0, 1, buffer_size=4096, read_at=adapter,
                                ring=ring)
    nb.reset_engine_calls()
    chunks = []
    for _ in range(2):              # two epochs: reset() re-reads
        native.reset(0, 1)
        epoch = []
        while True:
            view = native.next_chunk_view()
            if view is None:
                break
            epoch.append(ctypes.string_at(*view))
        chunks.append(epoch)
    native.close()
    adapter.close()
    assert chunks[0] == chunks[1]
    assert b"".join(chunks[0]) == blob and len(chunks[0]) > 4
    assert nb.ENGINE_CALLS["lsplit_next_chunk"] == 2 * len(chunks[0])


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("fmt", ["text", "indexed_recordio", "cached"])
def test_failed_remote_read_reraises_the_adapters_exception(
        tmp_path, store, monkeypatch, fmt):
    """A remote read that fails on the prefetch thread parks its exception
    on the adapter; the consumer re-raises that very exception, not the
    native engine's "read failed" text."""
    if fmt == "indexed_recordio":
        rec, idx, _ = indexed_file(tmp_path)
        uri, kw = upload(store, rec), dict(index_uri=upload(store, idx),
                                           batch_size=5)
    else:
        uri, kw = upload(store, text_files(tmp_path)[0]), {}
    if fmt == "cached":
        uri += f"#{tmp_path / 'c.cache'}"
    use(monkeypatch, "native")
    boom = _Boom("remote read failed: injected")

    def failing_read(self, nbytes):
        raise boom

    split = psplit.create_input_split(
        uri, 0, 1, "text" if fmt == "cached" else fmt, **kw)
    from dmlc_core_tpu_torch.io import s3_filesys

    monkeypatch.setattr(s3_filesys.S3ReadStream, "read", failing_read)
    with pytest.raises(_Boom) as info:
        split.before_first()
        while split.next_chunk() is not None:
            pass
    assert info.value is boom
    monkeypatch.undo()
    split.close()


def test_vanished_object_surfaces_the_store_error(tmp_path, store,
                                                  monkeypatch):
    store.objects[("bucket", "e/x.txt")] = b"a\nb\nc\n"
    use(monkeypatch, "native")
    split = psplit.create_input_split("s3://bucket/e/x.txt", 0, 1, "text")
    split.before_first()
    del store.objects[("bucket", "e/x.txt")]
    split.before_first()            # a new epoch reopens the object
    with pytest.raises(Exception) as info:
        while split.next_chunk() is not None:
            pass
    assert "callback failed" not in str(info.value)
    assert isinstance(info.value, FileNotFoundError)
    split.close()


def _threads():
    return len(os.listdir("/proc/self/task"))


def _settle(limit):
    deadline = time.monotonic() + 10
    while _threads() > limit and time.monotonic() < deadline:
        time.sleep(0.05)
    return _threads()


def test_close_in_the_middle_of_an_epoch_returns_at_once(tmp_path, store,
                                                         monkeypatch):
    """A slow store: closing (and resetting) a split whose read-ahead
    thread is inside a callback read returns within 5 s and leaves no
    thread behind."""
    blob = make_libsvm(n=30_000, seed=8)
    store.objects[("bucket", "slow.txt")] = blob
    use(monkeypatch, "native")
    from dmlc_core_tpu_torch.io import s3_filesys

    real_read = s3_filesys.S3ReadStream.read

    def slow_read(self, nbytes):
        time.sleep(0.05)
        return real_read(self, nbytes)

    monkeypatch.setattr(s3_filesys.S3ReadStream, "read", slow_read)
    before = _settle(10 ** 6)
    for action in ("close", "reset_partition", "before_first"):
        split = psplit.create_input_split("s3://bucket/slow.txt", 0, 1,
                                          "text")
        split.hint_chunk_size(4096)
        assert split.next_record() is not None
        start = time.monotonic()
        if action != "close":
            getattr(split, action)(*((1, 2) if action == "reset_partition"
                                     else ()))
            assert split.next_record() is not None
        split.close()
        assert time.monotonic() - start < 5.0, action
    assert _settle(before) <= before


def test_mid_epoch_reset_repeats_over_bucket(store, monkeypatch):
    """The reference's repeat-read protocol over the callback engine: a
    mid-epoch reset repeats the prefix, a reset after the epoch repeats
    the whole epoch."""
    lines = [b"line-%04d-%s" % (i, bytes([65 + i % 26]) * 24)
             for i in range(600)]
    store.objects[("bucket", "rep/p0.txt")] = b"\n".join(lines[:300]) + b"\n"
    store.objects[("bucket", "rep/p1.txt")] = b"\n".join(lines[300:]) + b"\n"
    use(monkeypatch, "native")
    for nmax in (1, 37, 250):
        split = psplit.create_input_split(
            "s3://bucket/rep/p0.txt;s3://bucket/rep/p1.txt", 0, 1, "text")
        prefix = [bytes(split.next_record()) for _ in range(nmax)]
        split.before_first()
        full = read_all(split, close=False)
        split.before_first()
        again = read_all(split)
        assert full[:nmax] == prefix and full == again == lines


def test_native_remote_asked_without_a_compiler_raises(tmp_path, store,
                                                       monkeypatch):
    store.objects[("bucket", "g/x.txt")] = b"a\nb\n"
    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(nb, "_lib", None)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    use(monkeypatch, "native")
    with pytest.raises(RuntimeError, match="g.. not found"):
        psplit.create_input_split("s3://bucket/g/x.txt", 0, 1, "text")
    # the Python engine, the default for remote URIs, needs no compiler
    use(monkeypatch, "python")
    assert read_all(psplit.create_input_split("s3://bucket/g/x.txt", 0, 1,
                                              "text")) == [b"a", b"b"]
    assert sum(nb.ENGINE_CALLS.values()) == 0


def test_interpreter_exit_with_open_remote_native_splits(tmp_path):
    """Native remote splits left open in the middle of an epoch, with the
    store's handler threads in the same process, neither hang nor crash
    the exit."""
    blob = make_libsvm(n=20_000, seed=9)
    script = textwrap.dedent(f"""
        import os, sys
        sys.path.insert(0, {REPO!r})
        from tests.mock_s3 import MockS3
        store = MockS3().start()
        os.environ.update(AWS_ACCESS_KEY_ID="k", AWS_SECRET_ACCESS_KEY="s",
                          S3_ENDPOINT=f"http://127.0.0.1:{{store.port}}",
                          DMLC_TPU_NATIVE_REMOTE="1")
        store.objects[("bucket", "x.txt")] = open({str(tmp_path / 'x')!r},
                                                  "rb").read()
        from dmlc_core_tpu_torch.io.input_split import create_input_split
        splits = [create_input_split("s3://bucket/x.txt", p, 2, "text")
                  for p in range(2)]
        for s in splits:
            s.hint_chunk_size(4096)
            assert s.next_record() is not None
        print("left open")
    """)
    (tmp_path / "x").write_bytes(blob)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=60,
                          env={k: v for k, v in os.environ.items()
                               if k != "DMLC_TPU_DISABLE_NATIVE"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "left open"


def test_adapter_sentinel_drops_streams_and_stale_error(store):
    """The ``idx < 0`` call the engine makes between joining the old
    producer and starting the new one closes cached streams and forgets a
    parked error."""
    store.objects[("bucket", "s.bin")] = bytes(range(256)) * 40
    fs = pfs.get_filesystem(pfs.URI("s3://bucket/s.bin"))
    files = psplit._expand_input_files(fs, "s3://bucket/s.bin")
    adapter = psplit._ReadAtAdapter(fs, files)
    buf = ctypes.create_string_buffer(100)
    assert adapter(None, 0, 10, buf, 100) == 100
    assert buf.raw == (bytes(range(256)) * 40)[10:110]
    assert adapter(None, 5, 0, buf, 100) == -1       # no such file
    assert isinstance(adapter.error, IndexError)
    assert adapter._streams
    assert adapter(None, -1, 0, None, 0) == 0
    assert adapter.error is None and not adapter._streams
    lock = threading.Lock()
    with lock:                                       # callable under a lock
        assert adapter(None, 0, 0, buf, 4) == 4
    adapter.close()
