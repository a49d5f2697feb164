"""PyTorch port vs the JAX package: zero-copy columnar ingest.

The cases of ``tests/test_arrow_ingest.py``, each run through the JAX
package and the port on the same seeded Parquet and Arrow IPC files:

- the port's RowBlock columns are bitwise the JAX package's (and the text
  parse's of the same logical data): sparse, dense with NaN values and
  null cells, weights, empty row groups, row-group sharding exactly once;
- every refusal (float64, index dtype drift, nulls, misaligned lists, a
  list without ``index``, ``DMLC_ARROW_REQUIRE_ZERO_COPY``, no pyarrow)
  raises in both, with the same message;
- the copy ledger and the telemetry counters agree, and the port's columns
  are read-only views over the Arrow buffers;
- the page cache from Parquet (``write_block`` and ``DiskRowIter``), the
  binner over its views, and remote Parquet through the mock S3 store,
  including the published cache a second host fetches;
- the slice whole, at a small size: a Parquet file through the port's
  parser, batches, binner and CPU fit gives the JAX fit's trees on the
  same bins, within ``tests/test_torch_gbdt.py``'s tolerance.

Bitwise equality throughout: the columnar front door copies bytes.
"""

import shutil

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from dmlc_core_tpu import telemetry as j_telemetry  # noqa: E402
from dmlc_core_tpu.data import arrow_ingest as j_arrow  # noqa: E402
from dmlc_core_tpu.data import factory as j_factory  # noqa: E402
from dmlc_core_tpu.data import page_cache as j_page_cache  # noqa: E402
from dmlc_core_tpu.data.row_block import concat_blocks as j_concat  # noqa: E402
from dmlc_core_tpu_torch import telemetry as p_telemetry  # noqa: E402
from dmlc_core_tpu_torch.data import arrow_ingest as p_arrow  # noqa: E402
from dmlc_core_tpu_torch.data import factory as p_factory  # noqa: E402
from dmlc_core_tpu_torch.data import page_cache as p_page_cache  # noqa: E402
from dmlc_core_tpu_torch.data.iterators import DiskRowIter  # noqa: E402
from dmlc_core_tpu_torch.data.row_block import concat_blocks as p_concat  # noqa: E402
from dmlc_core_tpu_torch.io.ranged_read import RangedReadFile  # noqa: E402
from tests.mock_s3 import MockS3  # noqa: E402
from tests.test_torch_gbdt import (_assert_same_trees,  # noqa: E402,F401
                                   interpret_mode)

ROWS = 3000
COLUMNS = ("offset", "label", "weight", "field", "index", "value")


# ------------------------------------------------------------------ corpora --

def _sparse_data(rows=ROWS, seed=3, with_weight=False):
    rng = np.random.RandomState(seed)
    labels = (np.arange(rows) % 2).astype(np.float32)
    weights = (rng.rand(rows).astype(np.float32) + np.float32(0.5)
               if with_weight else None)
    idx_lists, val_lists = [], []
    for _ in range(rows):
        feats = np.sort(rng.choice(40, size=rng.randint(1, 6),
                                   replace=False)).astype(np.uint32)
        idx_lists.append(feats)
        val_lists.append(rng.rand(len(feats)).astype(np.float32))
    return labels, weights, idx_lists, val_lists


def _write_sparse_text(path, labels, weights, idx_lists, val_lists):
    lines = []
    for i, (idx, val) in enumerate(zip(idx_lists, val_lists)):
        head = (f"{float(labels[i])!r}:{float(weights[i])!r}"
                if weights is not None else f"{float(labels[i])!r}")
        lines.append(head + " " + " ".join(
            f"{j}:{float(v)!r}" for j, v in zip(idx, val)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _sparse_table(labels, weights, idx_lists, val_lists, list_type=None,
                  index_type=None, value_type=None):
    list_type = list_type or pa.large_list
    cols = {
        "label": pa.array(labels, type=pa.float32()),
        "index": pa.array([[int(j) for j in idx] for idx in idx_lists],
                          type=list_type(index_type or pa.uint32())),
        "value": pa.array([[float(v) for v in val] for val in val_lists],
                          type=list_type(value_type or pa.float32())),
    }
    if weights is not None:
        cols["weight"] = pa.array(weights, type=pa.float32())
    return pa.table(cols)


def _write_parquet(path, table, row_group_size=700):
    pq.write_table(table, str(path), row_group_size=row_group_size,
                   compression="none", use_dictionary=False)
    return str(path)


def _write_ipc(path, table, batch_rows=700):
    with pa.ipc.new_file(str(path), table.schema) as writer:
        for batch in table.to_batches(max_chunksize=batch_rows):
            writer.write_batch(batch)
    return str(path)


def _drain_one(factory, concat, uri, **kwargs):
    parser = factory.create_parser(uri, **kwargs)
    try:
        return concat(list(parser))
    finally:
        parser.close()


def _drain(uri, **kwargs):
    """The port's merged block, after checking it bitwise against the JAX
    package's on the same source."""
    got = _drain_one(p_factory, p_concat, uri, **kwargs)
    want = _drain_one(j_factory, j_concat, uri, **kwargs)
    _assert_bitwise(got, want)
    return got


def _assert_bitwise(got, want):
    assert got.size == want.size
    for name in COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            assert a.tobytes() == b.tobytes(), name


def _assert_blocks_byte_identical(a, b, with_weight=False):
    assert a.size == b.size
    assert np.array_equal(a.offset - a.offset[0], b.offset - b.offset[0])
    assert a.label.tobytes() == b.label.tobytes()
    assert a.index.tobytes() == b.index.tobytes()
    assert a.index.dtype == b.index.dtype
    assert a.value.tobytes() == b.value.tobytes()
    if with_weight:
        assert a.weight.tobytes() == b.weight.tobytes()


def _raises_alike(exc_j, exc_p, match, fn_j, fn_p):
    with pytest.raises(exc_j, match=match) as jerr:
        fn_j()
    with pytest.raises(exc_p, match=match) as perr:
        fn_p()
    assert str(perr.value) == str(jerr.value)


# -------------------------------------------------------------- differential --

@pytest.mark.parametrize("fmt,with_weight", [("parquet", False),
                                             ("parquet", True),
                                             ("arrow", False)])
def test_sparse_columnar_bitwise_jax_and_libsvm(tmp_path, fmt, with_weight):
    labels, weights, idx, val = _sparse_data(with_weight=with_weight)
    text = _write_sparse_text(tmp_path / "d.libsvm", labels, weights, idx,
                              val)
    table = _sparse_table(labels, weights, idx, val)
    path = (_write_parquet(tmp_path / "d.parquet", table) if fmt == "parquet"
            else _write_ipc(tmp_path / "d.arrow", table))
    _assert_blocks_byte_identical(_drain(text, type="libsvm"), _drain(path),
                                  with_weight=with_weight)


def _dense_data(rows=ROWS, feats=9, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, feats).astype(np.float32)
    x[rows // 3, 2] = np.float32("nan")          # a real NaN VALUE
    y = rng.randint(0, 2, rows).astype(np.float32)
    missing_at = (rows // 2, 4)                  # a MISSING cell (null)
    return x, y, missing_at


@pytest.mark.parametrize("missing", ["0.0", "nan"])
def test_dense_parquet_bitwise_jax_and_csv(tmp_path, missing):
    x, y, (mi, mj) = _dense_data()
    csv = tmp_path / "d.csv"
    with open(csv, "w") as f:
        for i, (yi, row) in enumerate(zip(y, x)):
            cells = [repr(float(v)) for v in row]
            if i == mi:
                cells[mj] = ""                   # empty cell -> ?missing=
            f.write(repr(float(yi)) + "," + ",".join(cells) + "\n")
    cols = {"label": pa.array(y, type=pa.float32())}
    for j in range(x.shape[1]):
        col = x[:, j].tolist()
        if j == mj:
            col[mi] = None                       # null cell -> ?missing=
        cols[f"f{j}"] = pa.array(col, type=pa.float32())
    parquet = _write_parquet(tmp_path / "d.parquet", pa.table(cols))
    a = _drain(f"{csv}?format=csv&label_column=0&missing={missing}")
    b = _drain(f"{parquet}?label_column=0&missing={missing}")
    _assert_blocks_byte_identical(a, b)


def test_dense_named_label_column_default(tmp_path):
    x, y, _ = _dense_data(rows=100)
    cols = {f"f{j}": pa.array(x[:, j], type=pa.float32())
            for j in range(x.shape[1])}
    cols["label"] = pa.array(y, type=pa.float32())
    parquet = _write_parquet(tmp_path / "d.parquet", pa.table(cols))
    block = _drain(parquet)
    assert block.label.tobytes() == y.tobytes()
    assert block.size == 100


@pytest.mark.parametrize("fmt", ["parquet", "feather", "ipc"])
def test_format_names_and_extensions_select_the_columnar_parsers(tmp_path,
                                                                 fmt):
    labels, weights, idx, val = _sparse_data(rows=200)
    table = _sparse_table(labels, weights, idx, val)
    path = str(tmp_path / "d.bin")
    if fmt == "parquet":
        _write_parquet(path, table)
    else:
        _write_ipc(path, table)
    by_type = _drain(path, type=fmt)
    by_arg = _drain(f"{path}?format={fmt}")
    _assert_bitwise(by_type, by_arg)
    parser = p_factory.create_parser(path, type=fmt, threaded=False)
    want = p_arrow.ParquetParser if fmt == "parquet" \
        else p_arrow.ArrowIPCParser
    assert isinstance(parser, want)
    parser.close()


def test_empty_row_groups_skipped(tmp_path):
    schema = pa.schema([("label", pa.float32()),
                        ("index", pa.large_list(pa.uint32()))])
    path = str(tmp_path / "e.parquet")
    with pq.ParquetWriter(path, schema) as writer:
        writer.write_table(pa.table({"label": pa.array([], pa.float32()),
                                     "index": pa.array(
                                         [], pa.large_list(pa.uint32()))}))
        writer.write_table(pa.table({"label": pa.array([1.0], pa.float32()),
                                     "index": pa.array(
                                         [[3]], pa.large_list(pa.uint32()))}))
    sizes = []
    for factory in (j_factory, p_factory):
        parser = factory.create_parser(path, threaded=False)
        blocks = list(parser)
        parser.close()
        sizes.append([(b.size, b.index.tolist()) for b in blocks])
    assert sizes[0] == sizes[1] == [(1, [3])]


def _part_blocks(factory, parquet, nparts):
    lists = []
    for k in range(nparts):
        parser = factory.create_parser(parquet, part_index=k,
                                       num_parts=nparts, threaded=False)
        lists.append(list(parser))
        parser.close()
    return lists


@pytest.mark.parametrize("fmt", ["parquet", "arrow"])
def test_unit_sharding_exactly_once(tmp_path, fmt):
    labels, weights, idx, val = _sparse_data(rows=1000)
    table = _sparse_table(labels, weights, idx, val)
    path = (_write_parquet(tmp_path / "d.parquet", table, row_group_size=128)
            if fmt == "parquet"
            else _write_ipc(tmp_path / "d.arrow", table, batch_rows=128))
    whole = _drain(path)
    j_lists = _part_blocks(j_factory, path, 3)
    p_lists = _part_blocks(p_factory, path, 3)
    for pl, jl in zip(p_lists, j_lists):
        assert len(pl) == len(jl)
        for a, b in zip(pl, jl):
            _assert_bitwise(a, b)
    assert sum(b.size for lst in p_lists for b in lst) == whole.size == 1000
    # shard k of n reads units k, k+n, ...: round-robin reassembly is whole
    merged = p_concat([lst[i] for i in range(max(map(len, p_lists)))
                       for lst in p_lists if i < len(lst)])
    assert merged.label.tobytes() == whole.label.tobytes()
    assert merged.value.tobytes() == whole.value.tobytes()


# ----------------------------------------------------- rejection, not drift --

def _refusal_cases(tmp_path):
    labels, weights, idx, val = _sparse_data(rows=50)
    return {
        "dense_float64": (pa.table({
            "label": pa.array([1.0, 0.0], pa.float32()),
            "f0": pa.array([1.0, 2.0], pa.float64())}), "f0.*double"),
        "sparse_value_float64": (_sparse_table(
            labels, weights, idx, val, value_type=pa.float64()), "value"),
        "index_dtype_drift": (_sparse_table(
            labels, weights, idx, val, index_type=pa.int64()), "index"),
        "misaligned_lists": (pa.table({
            "label": pa.array([0.0, 1.0], pa.float32()),
            "index": pa.array([[0, 1], [2]], pa.large_list(pa.uint32())),
            "value": pa.array([[1.0], [2.0]], pa.large_list(pa.float32())),
        }), "row lengths"),
        "null_sparse_row": (pa.table({
            "label": pa.array([0.0, 1.0], pa.float32()),
            "index": pa.array([[0, 1], None], pa.large_list(pa.uint32())),
        }), "null"),
        "list_without_index": (pa.table({
            "label": pa.array([0.0], pa.float32()),
            "vals": pa.array([[1.0]], pa.large_list(pa.float32())),
        }), "index"),
    }


@pytest.mark.parametrize("case", ["dense_float64", "sparse_value_float64",
                                  "index_dtype_drift", "misaligned_lists",
                                  "null_sparse_row", "list_without_index"])
def test_refusals_raise_alike(tmp_path, case):
    table, match = _refusal_cases(tmp_path)[case]
    path = _write_parquet(tmp_path / f"{case}.parquet", table)
    _raises_alike(
        j_arrow.ArrowIngestError, p_arrow.ArrowIngestError, match,
        lambda: _drain_one(j_factory, j_concat, path, threaded=False),
        lambda: _drain_one(p_factory, p_concat, path, threaded=False))
    if case == "index_dtype_drift":
        # an int64 index column IS the right dtype for an int64 cache
        block = _drain(path, threaded=False, index_dtype=np.int64)
        assert block.index.dtype == np.dtype(np.int64)


# ------------------------------------------------------- zero-copy evidence --

def _stats_alike(table, **kwargs):
    p_block, p_stats = p_arrow.table_to_block(table, **kwargs)
    j_block, j_stats = j_arrow.table_to_block(table, **kwargs)
    _assert_bitwise(p_block, j_block)
    assert p_stats == j_stats
    return p_block, p_stats


def test_ipc_views_alias_arrow_buffers_and_are_readonly(tmp_path):
    labels, weights, idx, val = _sparse_data(rows=400, with_weight=True)
    ipc = _write_ipc(tmp_path / "d.arrow",
                     _sparse_table(labels, weights, idx, val),
                     batch_rows=400)
    mm = pa.memory_map(ipc)
    table = pa.Table.from_batches([pa.ipc.open_file(mm).get_batch(0)])
    block, stats = _stats_alike(table)
    assert stats["bulk_copy_columns"] == 0
    assert stats["zero_copy_columns"] >= 6
    for name in ("offset", "label", "weight", "index", "value"):
        arr = getattr(block, name)
        assert not arr.flags.writeable, name
        assert not arr.flags.owndata, name
    child = table.column("value").chunk(0).values
    arrow_view = np.frombuffer(child.buffers()[1], dtype=np.float32,
                               count=len(child) + child.offset)
    assert np.shares_memory(block.value, arrow_view)


def test_plain_list_offsets_counted_as_bulk_copy(monkeypatch):
    labels, weights, idx, val = _sparse_data(rows=50)
    table = _sparse_table(labels, weights, idx, val, list_type=pa.list_)
    block, stats = _stats_alike(table)
    assert block.size == 50 and stats["bulk_copy_columns"] >= 1
    assert any("offsets" in r for r in stats["bulk_copy_reasons"])
    monkeypatch.setenv("DMLC_ARROW_REQUIRE_ZERO_COPY", "1")
    _raises_alike(j_arrow.ArrowIngestError, p_arrow.ArrowIngestError,
                  "REQUIRE_ZERO_COPY", lambda: j_arrow.table_to_block(table),
                  lambda: p_arrow.table_to_block(table))


def test_strict_knob_rejects_dense_interleave(monkeypatch):
    x, y, _ = _dense_data(rows=20)
    cols = {"label": pa.array(y, pa.float32())}
    for j in range(x.shape[1]):
        cols[f"f{j}"] = pa.array(x[:, j], pa.float32())
    table = pa.table(cols)
    _, stats = _stats_alike(table, label_column=0)
    assert stats["bulk_copy_columns"] == 1
    monkeypatch.setenv("DMLC_ARROW_REQUIRE_ZERO_COPY", "1")
    _raises_alike(
        j_arrow.ArrowIngestError, p_arrow.ArrowIngestError, "interleave",
        lambda: j_arrow.table_to_block(table, label_column=0),
        lambda: p_arrow.table_to_block(table, label_column=0))


def _counter_deltas(telemetry, factory, concat, parquet):
    was_enabled = telemetry.enabled()
    telemetry.enable()
    try:
        reg = telemetry.get_registry()
        counters = (reg.counter("dmlc_ingest_rows_total", format="parquet"),
                    reg.counter("dmlc_ingest_columns_total",
                                mode="zero_copy"),
                    reg.counter("dmlc_ingest_columns_total",
                                mode="bulk_copy"))
        before = [c.value for c in counters]
        block = _drain_one(factory, concat, parquet, threaded=False)
        return block.size, [c.value - b for c, b in zip(counters, before)]
    finally:
        if not was_enabled:
            telemetry.disable()


def test_ingest_telemetry_counters_match_jax(tmp_path):
    labels, weights, idx, val = _sparse_data(rows=500)
    parquet = _write_parquet(tmp_path / "d.parquet",
                             _sparse_table(labels, weights, idx, val))
    got = _counter_deltas(p_telemetry, p_factory, p_concat, parquet)
    want = _counter_deltas(j_telemetry, j_factory, j_concat, parquet)
    assert got == want
    rows, (d_rows, d_zero, d_bulk) = got
    assert rows == d_rows == 500 and d_zero > 0 and d_bulk == 0


# ------------------------------------------------- page cache + remote paths --

def _cache_epochs(factory, uri):
    it = factory.create_row_block_iter(uri)
    try:
        epoch1 = list(it)
        it.before_first()
        epoch2 = list(it)
        for a, b in zip(epoch1, epoch2):
            assert a.offset is b.offset and a.value is b.value
            assert not a.index.flags.writeable
        return it, epoch1
    except BaseException:
        it.close()
        raise


def test_page_cache_from_parquet_bitwise_jax(tmp_path):
    labels, weights, idx, val = _sparse_data()
    text = _write_sparse_text(tmp_path / "d.libsvm", labels, weights, idx,
                              val)
    parquet = _write_parquet(tmp_path / "d.parquet",
                             _sparse_table(labels, weights, idx, val))
    p_it, p_epoch = _cache_epochs(p_factory,
                                  f"{parquet}#{tmp_path / 'p.cache'}")
    j_it, j_epoch = _cache_epochs(j_factory,
                                  f"{parquet}#{tmp_path / 'j.cache'}")
    try:
        assert isinstance(p_it, DiskRowIter)
        assert sum(b.size for b in p_epoch) == ROWS
        _assert_bitwise(p_concat(p_epoch), j_concat(j_epoch))
        _assert_blocks_byte_identical(_drain(text, type="libsvm"),
                                      p_concat(p_epoch))
    finally:
        p_it.close()
        j_it.close()
    # the two packages' caches are the same bytes
    with open(tmp_path / "p.cache", "rb") as f, \
            open(tmp_path / "j.cache", "rb") as g:
        assert f.read() == g.read()


def test_write_block_direct_arrow_to_page_cache(tmp_path):
    labels, weights, idx, val = _sparse_data(rows=300, with_weight=True)
    table = _sparse_table(labels, weights, idx, val)
    caches = []
    for arrow, page_cache, tag in ((p_arrow, p_page_cache, "p"),
                                   (j_arrow, j_page_cache, "j")):
        block, stats = arrow.table_to_block(table)
        assert stats["bulk_copy_columns"] == 0
        cache = str(tmp_path / f"{tag}.cache")
        writer = page_cache.PageCacheWriter(cache)
        writer.write_block(block)
        writer.commit()
        reader = page_cache.PageCacheReader(cache)
        [served] = reader.blocks
        for name in ("label", "index", "value", "weight", "offset"):
            assert getattr(served, name).tobytes() == \
                getattr(block, name).tobytes(), name
        reader.close()
        with open(cache, "rb") as f:
            caches.append(f.read())
    assert caches[0] == caches[1]


def test_fit_binner_over_parquet_cache_views(tmp_path):
    from dmlc_core_tpu.bridge.binning import fit_binner as j_fit_binner
    from dmlc_core_tpu_torch.bridge.binning import fit_binner

    x = np.random.RandomState(7).randn(800, 4).astype(np.float32)
    cols = {"label": pa.array(np.zeros(800, np.float32), pa.float32())}
    for j in range(4):
        cols[f"f{j}"] = pa.array(x[:, j], pa.float32())
    parquet = _write_parquet(tmp_path / "d.parquet", pa.table(cols))
    it = p_factory.create_row_block_iter(f"{parquet}#{tmp_path / 'c.cache'}")
    try:
        list(it)
        blocks = it.cache_blocks()
        assert blocks is not None
        binner = fit_binner(blocks, num_bins=16, num_feature=4)
        want = j_fit_binner(x, num_bins=16, num_feature=4)
        for a, b in zip(binner.boundaries, want.boundaries):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    finally:
        it.close()


@pytest.fixture()
def mock_s3(monkeypatch, tmp_path):
    server = MockS3().start()
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "test-key")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "test-secret")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.setenv("S3_ENDPOINT", f"http://127.0.0.1:{server.port}")
    monkeypatch.setenv("DMLC_CACHE_LOCAL_DIR", str(tmp_path / "materialized"))
    monkeypatch.delenv("DMLC_CACHE_REMOTE", raising=False)
    yield server
    server.stop()


def test_remote_parquet_ranged_reads(mock_s3, tmp_path):
    labels, weights, idx, val = _sparse_data(rows=800)
    parquet = _write_parquet(tmp_path / "d.parquet",
                             _sparse_table(labels, weights, idx, val),
                             row_group_size=100)
    with open(parquet, "rb") as f:
        mock_s3.objects[("bucket", "d.parquet")] = f.read()
    local = _drain(parquet)
    remote = _drain("s3://bucket/d.parquet")
    _assert_bitwise(remote, local)
    part0 = _drain("s3://bucket/d.parquet", part_index=0, num_parts=2)
    part1 = _drain("s3://bucket/d.parquet", part_index=1, num_parts=2)
    assert part0.size + part1.size == 800


def test_remote_parquet_to_published_cache_fleet_fetch(mock_s3, tmp_path,
                                                      monkeypatch):
    labels, weights, idx, val = _sparse_data(rows=600)
    parquet = _write_parquet(tmp_path / "d.parquet",
                             _sparse_table(labels, weights, idx, val))
    with open(parquet, "rb") as f:
        mock_s3.objects[("bucket", "d.parquet")] = f.read()
    monkeypatch.setenv("DMLC_CACHE_REMOTE", "1")
    was_enabled = p_telemetry.enabled()
    p_telemetry.enable()
    try:
        reg = p_telemetry.get_registry()
        hits = reg.counter("dmlc_cache_remote_hits_total")
        publishes = reg.counter("dmlc_cache_remote_publishes_total")
        h0, p0 = hits.value, publishes.value
        uri = "s3://bucket/d.parquet#s3://bucket/caches/d.rbc"
        it = p_factory.create_row_block_iter(uri)
        first = p_concat(list(it))
        it.close()
        assert first.size == 600 and publishes.value == p0 + 1
        assert ("bucket", "caches/d.rbc") in mock_s3.objects
        _assert_bitwise(first, _drain_one(j_factory, j_concat, parquet))
        # a second host: fresh local dir, fetches the cache, parquet unread
        shutil.rmtree(str(tmp_path / "materialized"), ignore_errors=True)
        del mock_s3.objects[("bucket", "d.parquet")]
        it2 = p_factory.create_row_block_iter(uri)
        assert sum(b.size for b in it2) == 600
        it2.close()
        assert hits.value == h0 + 1
    finally:
        if not was_enabled:
            p_telemetry.disable()


# ------------------------------------------------------------ io + gating ----

def test_ranged_read_file_semantics(tmp_path):
    path = tmp_path / "blob.bin"
    payload = bytes(range(256)) * 16
    path.write_bytes(payload)
    with RangedReadFile(str(path)) as f:
        assert f.size() == len(payload)
        assert f.read(4) == payload[:4]
        assert f.seek(-8, 2) == len(payload) - 8
        assert f.read() == payload[-8:]
        f.seek(len(payload) + 100)
        assert f.read(10) == b""
        with pytest.raises(ValueError):
            f.seek(0, 9)
    with pytest.raises(ValueError, match="closed"):
        f.read(1)


def test_pyarrow_absent_raises_one_clear_error(tmp_path, monkeypatch):
    for mod in (j_arrow, p_arrow):
        monkeypatch.setattr(mod, "pa", None)
        monkeypatch.setattr(mod, "pq", None)
        monkeypatch.setattr(mod, "_PYARROW_ERROR",
                            ImportError("No module named 'pyarrow'"))
    assert not p_arrow.pyarrow_available()
    target = str(tmp_path / "d.parquet")
    _raises_alike(RuntimeError, RuntimeError, "pyarrow",
                  lambda: j_factory.create_parser(target),
                  lambda: p_factory.create_parser(target))
    with pytest.raises(RuntimeError, match="pyarrow"):
        p_arrow.ParquetParser(target)
    # ... and the text front door is untouched by the absence
    (tmp_path / "t.libsvm").write_text("1 0:1.5\n")
    assert _drain(str(tmp_path / "t.libsvm"), type="libsvm").size == 1


# ------------------------------------------------- the slice, at a small size --

def test_parquet_to_fit_matches_jax(tmp_path, interpret_mode):  # noqa: F811
    """A Parquet file -> the port's create_parser -> dense_batches ->
    HostBinner -> GBDT.fit_binned on the CPU, against the JAX fit of the
    same bins (``tests/test_torch_gbdt.py``'s tolerance)."""
    import torch

    from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
    from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
    from dmlc_core_tpu_torch.bridge.batching import dense_batches
    from dmlc_core_tpu_torch.bridge.binning import HostBinner, fit_binner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam

    n, nf = 1200, 6
    rng = np.random.RandomState(12)
    x = rng.randn(n, nf).astype(np.float32)
    y = (x @ rng.randn(nf).astype(np.float32) > 0).astype(np.float32)
    cols = {"label": pa.array(y, pa.float32())}
    for j in range(nf):
        cols[f"f{j}"] = pa.array(x[:, j], pa.float32())
    parquet = _write_parquet(tmp_path / "fit.parquet", pa.table(cols),
                             row_group_size=250)
    parser = p_factory.create_parser(parquet)
    batches = list(dense_batches(parser, 256, nf))
    parser.close()
    xs = torch.cat([b.x[:b.num_rows] for b in batches]).numpy()
    ys = torch.cat([b.label[:b.num_rows] for b in batches]).numpy()
    np.testing.assert_array_equal(xs, x)
    np.testing.assert_array_equal(ys, y)
    kw = dict(num_boost_round=3, max_depth=4, num_bins=32,
              hist_method="pallas")
    edges = fit_binner(xs, num_bins=32).boundaries
    bins = HostBinner(edges, 32).transform(xs)
    pm = GBDT(GBDTParam(**kw), num_feature=nf, device="cpu")
    pm.set_boundaries(edges)
    p_ens, p_margin = pm.fit_binned(torch.from_numpy(bins), ys)
    jm = JaxGBDT(JaxParam(**kw), num_feature=nf)
    jm.set_boundaries(edges)
    j_ens, j_margin = jm.fit_binned(bins, ys)
    _assert_same_trees(p_ens, j_ens, 1e-4)
    np.testing.assert_allclose(p_margin.numpy(), np.asarray(j_margin),
                               rtol=1e-4, atol=1e-4)
