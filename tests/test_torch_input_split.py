"""PyTorch port vs the JAX package: input splits on the CPU.

Text, recordio and indexed-recordio splits of the same seeded files, in 1-5
parts, through the port's native engine (the default) and its Python engine
(``DMLC_TPU_DISABLE_NATIVE``), against the JAX package's Python engine: each
part yields the same records, and the parts are disjoint and exhaustive.
Shuffled orders, ``#cachefile`` replays and the shuffle decorator match the
JAX package's for the same seed.  The native engine's read-ahead thread
must survive closes in the middle of an epoch, resets and interpreter exit.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from dmlc_core_tpu.io import input_split as jsplit
from dmlc_core_tpu.io import memory_io as jmem
from dmlc_core_tpu.io import recordio as jrio
from dmlc_core_tpu_torch import native_bridge as nb
from dmlc_core_tpu_torch.io import filesys as pfs
from dmlc_core_tpu_torch.io import input_split as psplit
from tests.test_torch_native import (jax_python_engine,  # noqa: F401
                                     make_messy_libsvm, use_engine)
from tests.test_torch_recordio import make_records

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ("native", "python")
PORT_CLASS = {"native": psplit.NativeLineSplitter,
              "python": psplit.ThreadedInputSplit}


def _use(monkeypatch, engine):
    use_engine(monkeypatch, "numpy" if engine == "python" else "native")


def text_files(tmp_path):
    """Three text files of messy lines, CR/LF mixed, uneven lengths."""
    paths = []
    for k in range(3):
        path = tmp_path / f"part{k}.txt"
        path.write_bytes(make_messy_libsvm(n=150 + 60 * k, seed=20 + k))
        paths.append(str(path))
    lines = []
    for path in paths:
        with open(path, "rb") as f:
            text = f.read().replace(b"\r", b"\n")
        lines += [line for line in text.split(b"\n") if line]
    return ";".join(paths), lines


def rec_files(tmp_path, nfiles=2):
    """RecordIO files written by the JAX writer; (uri, records)."""
    paths, records = [], []
    for k in range(nfiles):
        recs = make_records(30 + k, n=250)
        stream = jmem.MemoryStringStream()
        writer = jrio.RecordIOWriter(stream)
        for rec in recs:
            writer.write_record(rec)
        path = tmp_path / f"d{k}.rec"
        path.write_bytes(bytes(stream.data))
        paths.append(str(path))
        records += recs
    return ";".join(paths), records


def indexed_file(tmp_path, n=230):
    records = make_records(40, n=n)
    stream = jmem.MemoryStringStream()
    writer = jrio.IndexedRecordIOWriter(stream)
    for rec in records:
        writer.write_record(rec)
    rec = tmp_path / "data.rec"
    rec.write_bytes(bytes(stream.data))
    index = jmem.MemoryStringStream()
    writer.save_index(index)
    idx = tmp_path / "data.idx"
    idx.write_bytes(bytes(index.data))
    return str(rec), str(idx), records


def read_all(split, close=True):
    try:
        return [bytes(r) for r in iter(split.next_record, None)]
    finally:
        if close:
            split.close()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 5])
def test_text_parts_match_jax_python_engine(tmp_path, monkeypatch,
                                            jax_python_engine, nparts,
                                            engine):
    uri, lines = text_files(tmp_path)
    _use(monkeypatch, engine)
    every = []
    for part in range(nparts):
        split = psplit.create_input_split(uri, part, nparts, "text")
        assert isinstance(split, PORT_CLASS[engine])
        got = read_all(split)
        assert got == read_all(jsplit.create_input_split(uri, part, nparts,
                                                         "text"))
        every += got
    assert every == lines            # disjoint and exhaustive, in order
    assert (nb.ENGINE_CALLS["lsplit_next_chunk"] > 0) == (engine == "native")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 5])
def test_recordio_parts_match_jax_python_engine(tmp_path, monkeypatch,
                                                jax_python_engine, nparts,
                                                engine):
    uri, records = rec_files(tmp_path)
    _use(monkeypatch, engine)
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
@pytest.mark.parametrize("nparts", [1, 2, 3, 4, 5])
def test_indexed_parts_match_jax_python_engine(tmp_path, monkeypatch,
                                               jax_python_engine, nparts,
                                               engine, shuffle):
    rec, idx, records = indexed_file(tmp_path)
    _use(monkeypatch, engine)
    kw = dict(index_uri=idx, shuffle=shuffle, seed=3, batch_size=7)
    every = []
    for part in range(nparts):
        got = read_all(psplit.create_input_split(rec, part, nparts,
                                                 "indexed_recordio", **kw))
        want = read_all(jsplit.create_input_split(rec, part, nparts,
                                                  "indexed_recordio", **kw))
        assert got == want
        every += got
    assert sorted(every) == sorted(records)
    if not shuffle:
        assert every == records
    assert (nb.ENGINE_CALLS["span_next_chunk"] > 0) == (engine == "native")


def test_indexed_shuffled_epochs_match_jax_and_differ(tmp_path, monkeypatch,
                                                      jax_python_engine):
    rec, idx, records = indexed_file(tmp_path)
    kw = dict(index_uri=idx, shuffle=True, seed=11, batch_size=16,
              threaded=False)
    orders = {}
    for engine in ENGINES + ("jax",):
        if engine == "jax":
            split = jsplit.create_input_split(rec, 0, 1, "indexed_recordio",
                                              **kw)
        else:
            _use(monkeypatch, engine)
            split = psplit.create_input_split(rec, 0, 1, "indexed_recordio",
                                              **kw)
        first = read_all(split, close=False)
        split.before_first()
        orders[engine] = (first, read_all(split))
    assert orders["native"] == orders["python"] == orders["jax"]
    first, second = orders["native"]
    assert sorted(first) == sorted(second) == sorted(records)
    assert first != second


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt", ["text", "recordio", "indexed_recordio"])
def test_cachefile_replay_equals_epoch_one(tmp_path, monkeypatch,
                                           jax_python_engine, fmt, engine):
    if fmt == "text":
        uri, want = text_files(tmp_path)
        kw = {}
    elif fmt == "recordio":
        uri, want = rec_files(tmp_path)
        kw = {}
    else:
        uri, idx, want = indexed_file(tmp_path)
        kw = dict(index_uri=idx, batch_size=9)
    _use(monkeypatch, engine)
    cache = tmp_path / "split.cache"
    split = psplit.create_input_split(f"{uri}#{cache}", 0, 1, fmt, **kw)
    native_cached = engine == "native" and fmt != "indexed_recordio"
    assert isinstance(split, psplit.NativeCachedSplitter if native_cached
                      else psplit.CachedInputSplit)
    first = read_all(split, close=False)
    assert os.path.getsize(cache) > 0
    split.before_first()
    second = read_all(split, close=False)
    split.before_first()
    third = read_all(split)
    assert first == second == third == want
    jax_cache = tmp_path / "jax.cache"
    assert first == read_all(jsplit.create_input_split(
        f"{uri}#{jax_cache}", 0, 1, fmt, **kw))
    if native_cached:
        assert nb.ENGINE_CALLS["creplay_next_chunk"] > 0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt,nparts,nshuffle",
                         [("text", 1, 4), ("text", 2, 3), ("recordio", 1, 3),
                          ("recordio", 2, 1)])
def test_shuffle_decorator_matches_jax(tmp_path, monkeypatch,
                                       jax_python_engine, fmt, nparts,
                                       nshuffle, engine):
    uri, want = (text_files if fmt == "text" else rec_files)(tmp_path)
    _use(monkeypatch, engine)
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


def test_batch_size_change_mid_epoch_resyncs(tmp_path):
    """Changing the batch size mid-epoch abandons the native plan exactly at
    the records already delivered: none lost, none repeated."""
    rec, idx, records = indexed_file(tmp_path)
    split = psplit.IndexedRecordIOSplitter(pfs.LocalFileSystem(), rec, idx,
                                           0, 1, batch_size=10)
    assert split._native_reader() is not None
    chunks = [split.next_chunk() for _ in range(3)]     # 30 records natively
    split.set_batch_size(4)
    rest = list(iter(split.next_chunk, None))
    split.close()
    got = []
    for chunk in chunks + rest:
        cursor = psplit.ChunkCursor(chunk)
        got += [bytes(r) for r in iter(
            lambda: psplit._next_recordio_record(cursor), None)]
    assert got == records


@pytest.mark.parametrize("fmt", ["line", "recordio"])
def test_tiny_buffer_forces_native_growth(tmp_path, fmt):
    """A buffer smaller than one record drives the engine's grow-and-retry
    loop: records still come out whole and in order."""
    if fmt == "line":
        recs = [b"x" * (50 + 37 * i) for i in range(40)]
        blob = b"\n".join(recs) + b"\n"
    else:
        recs = [b"y" * (48 + 36 * i) for i in range(40)]
        stream = jmem.MemoryStringStream()
        writer = jrio.RecordIOWriter(stream)
        for r in recs:
            writer.write_record(r)
        blob = bytes(stream.data)
    path = tmp_path / "d.bin"
    path.write_bytes(blob)
    native = nb.NativeLineSplit([str(path)], [len(blob)], 0, 1,
                                buffer_size=64, format=fmt)
    chunks = list(iter(native.next_chunk, None))
    native.close()
    assert b"".join(chunks) == blob
    extract = (psplit._next_line_record if fmt == "line"
               else psplit._next_recordio_record)
    got = []
    for chunk in chunks:
        cursor = psplit.ChunkCursor(chunk)
        got += [bytes(r) for r in iter(lambda: extract(cursor), None)]
    assert got == recs


def _threads():
    return len(os.listdir("/proc/self/task"))


def _settle(limit):
    deadline = time.monotonic() + 10
    while _threads() > limit and time.monotonic() < deadline:
        time.sleep(0.05)
    return _threads()


def test_close_and_reset_mid_epoch_join_the_read_ahead_thread(tmp_path):
    uri, lines = text_files(tmp_path)
    before = _settle(10 ** 6)
    split = psplit.NativeLineSplitter(pfs.LocalFileSystem(), uri, 0, 1)
    split.hint_chunk_size(8 << 20)
    assert split.next_record() is not None
    split.reset_partition(1, 2)          # in the middle of an epoch
    second_half = read_all(split, close=False)
    split.reset_partition(0, 1)
    split.next_chunk()
    split.close()                        # again in the middle of an epoch
    assert _settle(before) <= before
    assert second_half == read_all(psplit.create_input_split(uri, 1, 2,
                                                             "text"))
    with pytest.raises(ValueError, match="closed"):
        split.next_chunk()


def test_interpreter_exit_with_open_native_splits(tmp_path):
    """Open native splits (line, recordio, cached, span reader) left in
    the middle of an epoch neither hang nor crash the exit."""
    uri, _ = text_files(tmp_path)
    rec, idx, _ = indexed_file(tmp_path)
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from dmlc_core_tpu_torch.io.input_split import create_input_split
        splits = [create_input_split({uri!r}, 0, 1, "text"),
                  create_input_split({rec!r}, 0, 1, "recordio"),
                  create_input_split({uri + '#' + str(tmp_path / 'c')!r},
                                     0, 1, "text"),
                  create_input_split({rec!r}, 0, 1, "indexed_recordio",
                                     index_uri={idx!r}, batch_size=5)]
        for s in splits:
            assert s.next_record() is not None
        print("left open")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=60,
                          env={k: v for k, v in os.environ.items()
                               if k != "DMLC_TPU_DISABLE_NATIVE"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "left open"


def test_small_chunks_and_empty_parts_match(tmp_path):
    """Many small chunks through the double-buffered read-ahead yield the
    file's bytes; more parts than lines leaves empty parts that end at
    once."""
    uri, lines = text_files(tmp_path)
    assert read_all(psplit.create_input_split(uri, 0, 1, "text")) == lines
    path = uri.split(";")[0]
    blob = open(path, "rb").read()
    native = nb.NativeLineSplit([path], [len(blob)], 0, 1, buffer_size=256)
    chunks = list(iter(native.next_chunk, None))
    native.close()
    assert len(chunks) > 8 and b"".join(chunks) == blob
    small = tmp_path / "small.txt"
    small.write_bytes(b"a\nb\n")
    got = [read_all(psplit.create_input_split(str(small), p, 7, "text"))
           for p in range(7)]
    assert sum(got, []) == [b"a", b"b"]
