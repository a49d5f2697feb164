"""The port's page cache and row-block iterators against the JAX package's.

Blocks parsed from seeded libsvm files are written by both packages'
``PageCacheWriter``: the committed files must be byte-identical, so a cache
published to a bucket by either package is fetched by the other.  Damaged
caches raise ``CacheFormatError`` locally with the JAX package's message,
and remotely take the reference's loud stream-parse fallback with its
``dmlc_cache_remote_misses_total{reason=}``; ``io.cache.fetch`` faults never
serve a bad page.  ``BasicRowIter`` and ``DiskRowIter`` blocks are bitwise
the JAX package's.  The store is a strict ``MockS3``.
"""

import os
import shutil

import numpy as np
import pytest

from dmlc_core_tpu import fault as j_fault
from dmlc_core_tpu import telemetry as j_telemetry
from dmlc_core_tpu.data import factory as j_factory
from dmlc_core_tpu.data import iterators as j_iters
from dmlc_core_tpu.data import page_cache as j_cache
from dmlc_core_tpu.data.row_block import RowBlockContainer as JContainer
from dmlc_core_tpu.io import stream as j_stream
from dmlc_core_tpu_torch import fault as p_fault
from dmlc_core_tpu_torch import native_bridge as nb
from dmlc_core_tpu_torch import telemetry as p_telemetry
from dmlc_core_tpu_torch.data import factory as p_factory
from dmlc_core_tpu_torch.data import iterators as p_iters
from dmlc_core_tpu_torch.data import page_cache as p_cache
from dmlc_core_tpu_torch.data import row_block as p_row_block
from dmlc_core_tpu_torch.data.row_block import RowBlockContainer as PContainer
from tests.mock_s3 import MockS3
from tests.test_torch_native import jax_python_engine  # noqa: F401
from tests.test_torch_native import make_libsvm

ROWS = 2000
PKGS = {"jax": (j_factory, j_iters, j_cache, j_telemetry, j_fault,
                JContainer),
        "port": (p_factory, p_iters, p_cache, p_telemetry, p_fault,
                 PContainer)}
COLUMNS = ("offset", "label", "weight", "field", "index", "value")


@pytest.fixture
def store(monkeypatch, tmp_path):
    server = MockS3().start()
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-key")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.setenv("S3_ENDPOINT", f"http://127.0.0.1:{server.port}")
    monkeypatch.setenv("DMLC_CACHE_LOCAL_DIR", str(tmp_path / "local"))
    monkeypatch.delenv("DMLC_CACHE_REMOTE", raising=False)
    monkeypatch.delenv("DMLC_TPU_NATIVE_REMOTE", raising=False)
    yield server
    server.stop()


@pytest.fixture
def python_engines(monkeypatch, jax_python_engine):  # noqa: F811
    """Both packages on their numpy parsers: the same block boundaries, so
    the same pages."""
    monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")


def corpus(tmp_path, rows=ROWS, seed=3, name="data.libsvm"):
    path = tmp_path / name
    path.write_bytes(make_libsvm(n=rows, seed=seed))
    return str(path)


def cols(block):
    """A block's columns as (dtype, bytes), None where absent."""
    out = []
    for name in COLUMNS:
        col = getattr(block, name)
        out.append(None if col is None else (col.dtype.str, col.tobytes()))
    return tuple(out)


def blocks_of(it):
    return [cols(b) for b in it]


def merged(blocks, container_cls, dtype=np.uint32):
    container = container_cls(dtype)
    for block in blocks:
        container.push_block(block)
    return cols(container.get_block())


def parsed_blocks(uri, dtype=np.uint32, rows_per_block=500):
    """The JAX parse of ``uri``, cut into blocks of ``rows_per_block``."""
    parser = j_factory.create_parser(uri, type="libsvm", threaded=False,
                                     index_dtype=dtype)
    container = JContainer(dtype)
    for block in parser:
        container.push_block(block)
    parser.close()
    whole = container.get_block()
    return [whole.slice(i, min(i + rows_per_block, whole.size))
            for i in range(0, whole.size, rows_per_block)]


def write_cache(cache_mod, container_cls, blocks, path, dtype, per_page):
    writer = cache_mod.PageCacheWriter(path, dtype)
    for i in range(0, len(blocks), per_page):
        page = container_cls(dtype)
        for block in blocks[i:i + per_page]:
            page.push_block(block)
        writer.write_page(page)
    writer.commit()


def _counter(telemetry, name, **labels):
    return telemetry.get_registry().counter(name, **labels).value


class _Telemetry:
    """Both packages' telemetry on for a test, restored after."""

    def __enter__(self):
        self.was = [t.enabled() for t in (j_telemetry, p_telemetry)]
        for t in (j_telemetry, p_telemetry):
            t.enable()
        return self

    def __exit__(self, *exc):
        for t, was in zip((j_telemetry, p_telemetry), self.was):
            if not was:
                t.disable()


def test_row_block_layout_helpers_equal():
    from dmlc_core_tpu.data import row_block as j_row_block

    assert p_row_block.COLUMN_ORDER == j_row_block.COLUMN_ORDER
    for n in (0, 1, 7, 8, 9, 1 << 20):
        assert p_row_block.align8(n) == j_row_block.align8(n)
    for name in ("HEAD_MAGIC", "TAIL_MAGIC", "VERSION"):
        assert getattr(p_cache, name) == getattr(j_cache, name)
    assert p_fault.SITES["io.cache.fetch"] == j_fault.SITES["io.cache.fetch"]


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("per_page", [1, 3, 1000])
def test_cache_files_byte_identical(tmp_path, python_engines, dtype,
                                    per_page):
    blocks = parsed_blocks(corpus(tmp_path), dtype)
    files = {}
    for name, (_, _, cache_mod, _, _, container_cls) in PKGS.items():
        path = str(tmp_path / f"{name}.cache")
        write_cache(cache_mod, container_cls, blocks, path, dtype, per_page)
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]
    assert sorted(os.listdir(tmp_path)) == ["data.libsvm", "jax.cache",
                                            "port.cache"]    # no temp left
    reader = p_cache.PageCacheReader(str(tmp_path / "port.cache"), dtype)
    assert merged(reader.blocks, PContainer, dtype) == \
        merged(blocks, JContainer, dtype)
    reader.close()


def test_empty_cache_byte_identical(tmp_path):
    for name, (_, _, cache_mod, _, _, _) in PKGS.items():
        writer = cache_mod.PageCacheWriter(str(tmp_path / name), np.uint32)
        writer.commit()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert p_cache.PageCacheReader(str(tmp_path / "port")).blocks == []


def _damage(blob, kind):
    data = bytearray(blob)
    if kind == "truncated":
        return bytes(data[:len(data) // 2])
    if kind == "footerless":
        return bytes(data[:-40])
    if kind == "payload-bit":
        data[200] ^= 0x01
    elif kind == "toc-bit":
        data[-30] ^= 0x01
    elif kind == "head-magic":
        data[0:8] = b"DMLCRBC1"
    elif kind == "tiny":
        return bytes(data[:20])
    return bytes(data)


DAMAGE = ("truncated", "footerless", "payload-bit", "toc-bit", "head-magic",
          "tiny")


@pytest.mark.parametrize("kind", DAMAGE + ("dtype",))
def test_damaged_local_cache_raises_like_jax(tmp_path, python_engines, kind):
    blocks = parsed_blocks(corpus(tmp_path))
    good = str(tmp_path / "good.cache")
    write_cache(p_cache, PContainer, blocks, good, np.uint32, 2)
    bad = str(tmp_path / "bad.cache")
    with open(bad, "wb") as f:
        f.write(_damage(open(good, "rb").read(), kind))
    want_dtype = np.uint64 if kind == "dtype" else np.uint32
    errors = []
    for cache_mod in (j_cache, p_cache):
        with pytest.raises(cache_mod.CacheFormatError) as info:
            cache_mod.PageCacheReader(bad, want_dtype)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_damaged_local_cache_is_rebuilt_by_disk_iter(tmp_path,
                                                     python_engines):
    uri = corpus(tmp_path)
    cache = str(tmp_path / "d.cache")
    it = p_factory.create_row_block_iter(f"{uri}#{cache}", type="libsvm")
    first = blocks_of(it)
    it.close()
    with open(cache, "r+b") as f:
        f.seek(300)
        byte = f.read(1)
        f.seek(300)
        f.write(bytes([byte[0] ^ 0xFF]))
    with _Telemetry():
        r0 = _counter(p_telemetry, "dmlc_cache_rebuilds_total")
        it = p_factory.create_row_block_iter(f"{uri}#{cache}", type="libsvm")
        assert blocks_of(it) == first
        it.close()
        assert _counter(p_telemetry, "dmlc_cache_rebuilds_total") == r0 + 1


@pytest.mark.parametrize("engine", ["python", "native"])
def test_disk_row_iter_bitwise_jax(tmp_path, monkeypatch, jax_python_engine,  # noqa: F811
                                   engine):
    """Local ``#cachefile``: build, replay (the same mmap-backed objects
    every epoch) and the JAX package's blocks.  On the numpy engines the
    pages and files are the JAX package's; the native parser cuts other
    blocks, so there the merged columns are."""
    monkeypatch.setenv("DMLC_CACHE_PAGE_BYTES", str(1 << 20))
    if engine == "python":
        monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("DMLC_TPU_DISABLE_NATIVE", raising=False)
    uri = corpus(tmp_path, rows=40_000, seed=4)
    got = {}
    for name, (factory, iters, _, _, _, container_cls) in PKGS.items():
        cache = str(tmp_path / f"{name}.cache")
        it = factory.create_row_block_iter(f"{uri}#{cache}", type="libsvm")
        assert isinstance(it, iters.DiskRowIter)
        epoch1 = list(it)
        it.before_first()
        epoch2 = list(it)
        if name == "port":
            for a, b in zip(epoch1, epoch2):
                assert a.offset is b.offset and a.index is b.index
                assert not a.index.flags.writeable
        got[name] = ([cols(b) for b in epoch2],
                     merged(epoch2, container_cls),
                     open(cache, "rb").read())
        it.close()
    if engine == "python":
        assert got["port"] == got["jax"]
        assert len(got["port"][0]) > 1
    else:
        assert got["port"][1] == got["jax"][1]


@pytest.mark.parametrize("remote", [False, True])
def test_basic_row_iter_bitwise_jax(tmp_path, store, python_engines, remote):
    uri = corpus(tmp_path, seed=6)
    if remote:
        store.objects[("bucket", "b.libsvm")] = open(uri, "rb").read()
        uri = "s3://bucket/b.libsvm"
    got = {}
    for name, (factory, iters, _, _, _, _) in PKGS.items():
        it = factory.create_row_block_iter(uri, type="libsvm")
        assert isinstance(it, iters.BasicRowIter)
        epoch1 = blocks_of(it)
        it.before_first()
        got[name] = (epoch1, blocks_of(it))
    assert got["port"] == got["jax"]
    assert got["port"][0] == got["port"][1] and len(got["port"][0]) == 1


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_cache_published_by_one_package_is_fetched_by_the_other(
        tmp_path, store, python_engines, monkeypatch, publisher):
    uri = corpus(tmp_path, rows=5000, seed=7)
    remote = "s3://bucket/caches/shared.cache"
    monkeypatch.setenv("DMLC_CACHE_PAGE_BYTES", str(1 << 20))
    fetcher = "port" if publisher == "jax" else "jax"
    factory, _, _, telemetry, _, _ = PKGS[publisher]
    monkeypatch.setenv("DMLC_CACHE_REMOTE", "1")
    with _Telemetry():
        p0 = _counter(telemetry, "dmlc_cache_remote_publishes_total")
        it = factory.create_row_block_iter(f"{uri}#{remote}", type="libsvm")
        published = blocks_of(it)
        it.close()
        assert _counter(telemetry,
                        "dmlc_cache_remote_publishes_total") == p0 + 1
        monkeypatch.delenv("DMLC_CACHE_REMOTE")
        monkeypatch.setenv("DMLC_CACHE_LOCAL_DIR", str(tmp_path / "host2"))
        _, iters, cache_mod, telemetry, _, _ = PKGS[fetcher]
        h0 = _counter(telemetry, "dmlc_cache_remote_hits_total")

        def no_parse():
            raise AssertionError("a fetch must not parse")

        it = iters.DiskRowIter(no_parse, remote)
        fetched = blocks_of(it)
        it.close()
        assert _counter(telemetry, "dmlc_cache_remote_hits_total") == h0 + 1
    assert fetched == published
    local = cache_mod.default_local_path(remote)
    assert open(local, "rb").read() == \
        store.objects[("bucket", "caches/shared.cache")]


def test_fleet_flow_over_bucket(tmp_path, store, monkeypatch):
    """The reference's fleet form on the port's default engines: epoch 1
    parses the bucket and publishes, epoch 2 replays from mmap, a second
    host fetches with no parse."""
    blob = make_libsvm(n=6000, seed=12)
    store.objects[("bucket", "train.libsvm")] = blob
    spec = "s3://bucket/train.libsvm#s3://bucket/caches/train.cache"
    monkeypatch.setenv("DMLC_CACHE_REMOTE", "1")
    with _Telemetry():
        p0 = _counter(p_telemetry, "dmlc_cache_remote_publishes_total")
        h0 = _counter(p_telemetry, "dmlc_cache_remote_hits_total")
        a0 = _counter(p_telemetry, "dmlc_cache_remote_misses_total",
                      reason="absent")
        it = p_factory.create_row_block_iter(spec)
        epoch1 = blocks_of(it)
        it.before_first()
        assert blocks_of(it) == epoch1
        it.close()
        assert _counter(p_telemetry,
                        "dmlc_cache_remote_publishes_total") == p0 + 1
        assert _counter(p_telemetry, "dmlc_cache_remote_misses_total",
                        reason="absent") == a0 + 1
        monkeypatch.setenv("DMLC_CACHE_LOCAL_DIR", str(tmp_path / "host2"))
        nb.reset_engine_calls()
        it = p_factory.create_row_block_iter(spec)
        assert blocks_of(it) == epoch1
        it.close()
        assert sum(nb.ENGINE_CALLS.values()) == 0
        assert _counter(p_telemetry, "dmlc_cache_remote_hits_total") == h0 + 1
        # the same host again: the local materialization, no bucket traffic
        store.requests.clear()
        it = p_factory.create_row_block_iter(spec)
        assert blocks_of(it) == epoch1
        it.close()
        assert store.requests == []
    parser = p_factory.create_parser("s3://bucket/train.libsvm")
    assert merged([b for b in parser], PContainer) == \
        merged(p_cache.PageCacheReader(
            p_cache.default_local_path("s3://bucket/caches/train.cache")
        ).blocks, PContainer)
    parser.close()


@pytest.mark.parametrize("kind", ("absent", "v1") + DAMAGE)
def test_untrustable_remote_cache_falls_back_loudly(tmp_path, store,
                                                    python_engines, kind):
    """Every untrustable remote shape ends in a stream parse with the JAX
    package's miss reason; the blocks are the parse's."""
    uri = corpus(tmp_path, seed=9)
    remote = f"s3://bucket/caches/{kind}.cache"
    if kind == "v1":
        container = PContainer(np.uint32)
        for block in parsed_blocks(uri):
            container.push_block(block)
        fo = j_stream.create_stream(remote, "w")
        container.save(fo)
        fo.close()
    elif kind != "absent":
        seed_cache = str(tmp_path / "seed.cache")
        write_cache(p_cache, PContainer, parsed_blocks(uri), seed_cache,
                    np.uint32, 2)
        store.objects[("bucket", f"caches/{kind}.cache")] = _damage(
            open(seed_cache, "rb").read(), kind)
    want_reason = "absent" if kind == "absent" else "invalid"
    got = {}
    with _Telemetry():
        for name, (factory, _, _, telemetry, _, _) in PKGS.items():
            shutil.rmtree(str(tmp_path / "local"), ignore_errors=True)
            misses = {r: _counter(telemetry, "dmlc_cache_remote_misses_total",
                                  reason=r)
                      for r in ("absent", "invalid", "io", "error")}
            it = factory.create_row_block_iter(f"{uri}#{remote}",
                                               type="libsvm")
            got[name] = blocks_of(it)
            it.close()
            moved = {r: _counter(telemetry, "dmlc_cache_remote_misses_total",
                                 reason=r) - v for r, v in misses.items()}
            assert moved == {r: int(r == want_reason) for r in moved}, name
    assert got["port"] == got["jax"] and got["port"]


@pytest.mark.parametrize("rule", [
    {"site": "io.cache.fetch", "kind": "truncate", "after": 2},
    {"site": "io.cache.fetch", "kind": "reset", "after": 2},
    {"site": "io.cache.fetch", "kind": "error", "after": 3},
])
def test_cache_fetch_faults_never_serve_a_bad_page(tmp_path, store,
                                                   python_engines,
                                                   monkeypatch, rule):
    uri = corpus(tmp_path, rows=5000, seed=10)
    remote = "s3://bucket/caches/faulty.cache"
    seed_cache = str(tmp_path / "seed.cache")
    blocks = parsed_blocks(uri)
    write_cache(p_cache, PContainer, blocks, seed_cache, np.uint32, 1)
    store.objects[("bucket", "caches/faulty.cache")] = \
        open(seed_cache, "rb").read()
    monkeypatch.setenv("DMLC_CACHE_PREFETCH", "1")
    want = merged(blocks, PContainer)
    p_fault.configure({"rules": [rule]})
    try:
        it = p_iters.DiskRowIter(
            lambda: p_factory.create_parser(uri, type="libsvm"), remote)
        got = list(it)
        assert merged(got, PContainer) == want
        it.close()
        fires = [(site, kind) for site, kind, _ in p_fault.fires()]
    finally:
        p_fault.clear()
    assert fires == [("io.cache.fetch", rule["kind"])]
    local = p_cache.default_local_path(remote)
    assert not [f for f in os.listdir(os.path.dirname(local))
                if f.endswith(".tmp")]


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_fetch_ring_depths_materialize_the_object(tmp_path, store,
                                                  python_engines, prefetch):
    uri = corpus(tmp_path, rows=4000, seed=11)
    seed_cache = str(tmp_path / "seed.cache")
    write_cache(j_cache, JContainer, parsed_blocks(uri), seed_cache,
                np.uint32, 1)
    blob = open(seed_cache, "rb").read()
    store.objects[("bucket", "c.cache")] = blob
    out = {}
    for name, cache_mod in (("jax", j_cache), ("port", p_cache)):
        local = str(tmp_path / f"{name}-{prefetch}.cache")
        n = cache_mod.fetch_remote_cache("s3://bucket/c.cache", local,
                                         np.uint32, prefetch=prefetch)
        out[name] = (n, open(local, "rb").read())
    assert out["port"] == out["jax"] == (len(blob), blob)
    j_layout = j_cache._open_remote_layout("s3://bucket/c.cache", np.uint32)
    p_layout = p_cache._open_remote_layout("s3://bucket/c.cache", np.uint32)
    assert p_layout.spans == j_layout.spans and len(p_layout.spans) > 4


def test_failed_publish_leaves_no_object(tmp_path, store, monkeypatch):
    monkeypatch.setenv("DMLC_S3_WRITE_BUFFER_MB", "5")
    local = str(tmp_path / "big.cache")
    with open(local, "wb") as f:
        f.write(np.random.RandomState(0).bytes(11 << 20))
    from dmlc_core_tpu_torch.io import s3_filesys

    real = s3_filesys.S3WriteStream.write
    calls = []

    def failing_write(self, data):
        calls.append(len(data))
        if len(calls) == 2:
            raise OSError("disk went away")
        return real(self, data)

    monkeypatch.setattr(s3_filesys.S3WriteStream, "write", failing_write)
    with pytest.raises(OSError, match="disk went away"):
        p_cache.publish_cache(local, "s3://bucket/caches/partial.cache")
    assert ("bucket", "caches/partial.cache") not in store.objects
    assert store.uploads == {}


@pytest.mark.parametrize("value,cache_file", [
    (None, "/tmp/c.cache"), (None, "s3://b/c.cache"), ("1", "s3://b/c.cache"),
    ("1", "/tmp/c.cache"), ("s3://b/x.cache", "/tmp/c.cache"),
    ("0", "s3://b/c.cache"), ("False", "s3://b/c.cache"),
    ("YES", "s3://b/c.cache"), ("maybe", "s3://b/c.cache")])
def test_remote_cache_config_equal(monkeypatch, value, cache_file):
    if value is None:
        monkeypatch.delenv("DMLC_CACHE_REMOTE", raising=False)
    else:
        monkeypatch.setenv("DMLC_CACHE_REMOTE", value)
    out = []
    for iters in (j_iters, p_iters):
        try:
            out.append(iters._remote_cache_config(cache_file))
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
    assert out[0] == out[1]


def test_default_local_path_equal(monkeypatch, tmp_path):
    for uri in ("s3://bucket/caches/train.cache", "gs://b/x/", "azure://c/d"):
        monkeypatch.delenv("DMLC_CACHE_LOCAL_DIR", raising=False)
        assert p_cache.default_local_path(uri) == \
            j_cache.default_local_path(uri)
        monkeypatch.setenv("DMLC_CACHE_LOCAL_DIR", str(tmp_path))
        assert p_cache.default_local_path(uri) == \
            j_cache.default_local_path(uri)
        assert p_cache.default_local_path(uri).startswith(str(tmp_path))
