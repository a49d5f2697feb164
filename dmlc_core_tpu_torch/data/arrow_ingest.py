"""Zero-copy columnar ingest: Arrow/Parquet buffers -> RowBlock, no parse stage.

Counterpart of ``dmlc_core_tpu/data/arrow_ingest.py`` (a copy): the same
mapping, copy ledger, refusals and pyarrow gate, on the port's parser,
RowBlock, telemetry and ranged reads.  It imports no torch.

The text parsers are the repo's ingest front door (SURVEY §2.6), but
production feature stores speak columnar.  This module is the second front
door: Arrow columnar buffers map *directly* onto the ``row_block.py``
COLUMN_ORDER layout — ``np.frombuffer`` views over the Arrow data buffers,
no tokenize, no strtonum, no per-row loop anywhere — and the resulting
RowBlocks flow into everything downstream unchanged (BasicRowIter,
DiskRowIter's v2 page-cache build + ``publish_cache``, ``fit_binner``,
DeviceFeedLoader).

Two container formats are served by one mapping (:func:`table_to_block`):

- **Parquet** (:class:`ParquetParser`): row groups decode into Arrow
  buffers at C++ speed (pages are def/rep-level encoded — that decode is
  the format's price), then map as views.  The interchange format.
- **Arrow IPC / feather v2** (:class:`ArrowIPCParser`): the Arrow memory
  layout on disk — a local file memory-maps and record batches serve as
  views over the mapping with *no decode stage at all*, the columnar
  analog of the v2 page cache's epoch>=2 replay.  The speed format.

Two schemas are understood, mirroring the two text formats:

- **sparse** (libsvm/libfm-equivalent): a ``label`` float32 column plus an
  ``index`` list column (element dtype == the cache index dtype), with
  optional ``value`` (list<float32>), ``weight`` (float32) and ``field``
  (list, element dtype == index dtype) columns.  List *offsets* become the
  CSR row pointers and list *values* become the CSR columns — with
  ``large_list`` (64-bit offsets) every column is a pure buffer view.
- **dense** (csv-equivalent): every non-label column is a float32 feature;
  ``label_column`` selects the label positionally (CSV semantics; a column
  literally named ``label`` is used when ``label_column`` is not given).
  Feature indices are renumbered sequentially, exactly like the CSV
  parser, so the output is byte-identical to the text parse of the same
  logical data.

**Zero-copy accounting is explicit, never silent.**  Every materialized
column increments ``dmlc_ingest_columns_total`` labeled ``mode=zero_copy``
(a numpy view aliasing the Arrow buffer) or ``mode=bulk_copy`` (one
vectorized materialization: 32->64-bit list-offset widening, null fill,
multi-chunk concat, or the dense row-major interleave — CSR is row-major
by definition, so a dense columnar source always pays that one transform).
There is no per-row fallback path at all: schema or dtype drift (a float64
value column, an index list not matching the requested index dtype) raises
:class:`ArrowIngestError` naming the column, because a silent cast would
break the byte-identity contract with the text parsers.  Setting
``DMLC_ARROW_REQUIRE_ZERO_COPY=1`` escalates any ``bulk_copy`` to an error
— the JAX package's engagement gate runs under it.

pyarrow is optional, gated like the HDFS backend: absent pyarrow, parser
construction raises one clear error and nothing else in the package is
affected.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.data.parser import Parser
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.param import get_env

try:  # the HDFS gating pattern: import errors surface at USE, not import
    import pyarrow as pa
    import pyarrow.parquet as pq
    _PYARROW_ERROR: Optional[BaseException] = None
except Exception as _exc:  # pragma: no cover - exercised via monkeypatch
    pa = None  # type: ignore[assignment]
    pq = None  # type: ignore[assignment]
    _PYARROW_ERROR = _exc

__all__ = ["ArrowIngestError", "ParquetParser", "ArrowIPCParser",
           "table_to_block", "pyarrow_available", "require_pyarrow"]


class ArrowIngestError(ValueError):
    """Schema/dtype drift between an Arrow source and the RowBlock layout.

    Raised instead of silently casting: the differential contract is that
    columnar ingest of a dataset is byte-identical to the text parse of
    the same logical data, and a quiet float64->float32 or int64->uint32
    narrowing would fork the two front doors' semantics."""


def pyarrow_available() -> bool:
    return pa is not None


def require_pyarrow() -> None:
    """Raise the one clear gating error when pyarrow is missing."""
    if pa is None:
        raise RuntimeError(
            "parquet/arrow ingest requires pyarrow (optional dependency, "
            "same gating as hdfs://): install pyarrow, or keep using the "
            f"text formats — import failed with: {_PYARROW_ERROR!r}")


def _require_zero_copy() -> bool:
    return get_env("DMLC_ARROW_REQUIRE_ZERO_COPY", bool, False)


class _CopyLedger:
    """Per-block zero-copy accounting: which columns were buffer views and
    which had to be materialized (and why).  The counters are the
    engagement gate's ground truth — a copy can regress loudly, never
    silently."""

    def __init__(self, ctx: str):
        self.ctx = ctx
        self.zero_copy = 0
        self.bulk_copy = 0
        self.bulk_reasons: List[str] = []

    def view(self, column: str) -> None:
        self.zero_copy += 1
        telemetry.count("dmlc_ingest_columns_total", mode="zero_copy")

    def bulk(self, column: str, why: str) -> None:
        if _require_zero_copy():
            raise ArrowIngestError(
                f"{self.ctx}: column {column!r} requires a bulk copy "
                f"({why}) and DMLC_ARROW_REQUIRE_ZERO_COPY is set")
        self.bulk_copy += 1
        self.bulk_reasons.append(f"{column}: {why}")
        telemetry.count("dmlc_ingest_columns_total", mode="bulk_copy")


def _np_dtype(pa_type) -> Optional[np.dtype]:
    try:
        return np.dtype(pa_type.to_pandas_dtype())
    except (NotImplementedError, TypeError):
        return None


def _one_chunk(chunked, column: str, ledger: _CopyLedger):
    """ChunkedArray -> Array; >1 chunk costs one combine (bulk, counted)."""
    if chunked.num_chunks == 1:
        return chunked.chunk(0)
    ledger.bulk(column, f"{chunked.num_chunks} chunks combined")
    return chunked.combine_chunks()


def _primitive_view(arr, want: np.dtype, column: str, ctx: str,
                    ledger: _CopyLedger, missing: Optional[float] = None
                    ) -> np.ndarray:
    """A primitive Arrow array as a numpy view of its data buffer.

    Exact-dtype only (drift raises).  Nulls are rejected unless ``missing``
    is given, in which case they are filled (one vectorized pass, counted
    as a bulk copy).  The returned view is read-only — same discipline as
    the page cache's mmap views."""
    have = _np_dtype(arr.type)
    if have is None or have != want:
        raise ArrowIngestError(
            f"{ctx}: dtype drift on column {column!r}: stored "
            f"{arr.type}, RowBlock layout needs {want.name} — cast at "
            "write time; columnar ingest never casts silently")
    filled = False
    if arr.null_count:
        if missing is None:
            raise ArrowIngestError(
                f"{ctx}: column {column!r} has {arr.null_count} null(s); "
                "only dense feature columns accept nulls (filled with the "
                "?missing= value)")
        ledger.bulk(column, f"{arr.null_count} nulls filled with {missing}")
        arr = arr.fill_null(missing)
        filled = True
    buf = arr.buffers()[1]
    view = np.frombuffer(buf, dtype=want, count=len(arr) + arr.offset
                         )[arr.offset:]
    view.flags.writeable = False
    if not filled:
        ledger.view(column)
    return view


def _list_parts(arr, column: str, ctx: str, ledger: _CopyLedger):
    """A (large_)list array -> (int64 CSR offsets, flat child array).

    ``large_list`` offsets are an int64 buffer view; plain ``list``
    (32-bit offsets) costs one widening pass, counted as a bulk copy —
    store ``large_list`` for the pure-view path."""
    if pa.types.is_large_list(arr.type):
        off_dtype = np.dtype(np.int64)
    elif pa.types.is_list(arr.type):
        off_dtype = np.dtype(np.int32)
    else:
        raise ArrowIngestError(
            f"{ctx}: column {column!r} must be a list/large_list, "
            f"stored {arr.type}")
    if arr.null_count:
        raise ArrowIngestError(
            f"{ctx}: sparse column {column!r} has {arr.null_count} "
            "null row(s); write empty lists for empty rows")
    raw = np.frombuffer(arr.buffers()[1], dtype=off_dtype,
                        count=len(arr) + 1 + arr.offset)[arr.offset:]
    if off_dtype == np.dtype(np.int64):
        offsets = raw
        offsets.flags.writeable = False
        ledger.view(f"{column}.offsets")
    else:
        ledger.bulk(f"{column}.offsets",
                    "32-bit list offsets widened to CSR int64 "
                    "(store large_list for the pure-view path)")
        offsets = raw.astype(np.int64)
    return offsets, arr.values


def _list_values_view(arr, offsets: np.ndarray, want: np.dtype, column: str,
                      ctx: str, ledger: _CopyLedger) -> np.ndarray:
    """The child-values span ``[offsets[0], offsets[-1])`` as a view."""
    values = _primitive_view(arr, want, f"{column}.values", ctx, ledger)
    return values[int(offsets[0]):int(offsets[-1])]


def _sparse_block(table, index_dtype: np.dtype, ctx: str,
                  ledger: _CopyLedger) -> RowBlock:
    names = table.column_names
    if "label" not in names:
        raise ArrowIngestError(
            f"{ctx}: sparse schema requires a 'label' column "
            f"(have {names})")
    label = _primitive_view(_one_chunk(table.column("label"), "label",
                                       ledger),
                            np.dtype(np.float32), "label", ctx, ledger)
    index_arr = _one_chunk(table.column("index"), "index", ledger)
    offsets, index_child = _list_parts(index_arr, "index", ctx, ledger)
    index = _list_values_view(index_child, offsets, index_dtype, "index",
                              ctx, ledger)

    def aligned_list(column: str, want: np.dtype) -> np.ndarray:
        arr = _one_chunk(table.column(column), column, ledger)
        col_offsets, child = _list_parts(arr, column, ctx, ledger)
        if not np.array_equal(offsets, col_offsets):
            raise ArrowIngestError(
                f"{ctx}: column {column!r} row lengths disagree with "
                "'index' — every sparse list column must have the same "
                "per-row element counts")
        return _list_values_view(child, col_offsets, want, column, ctx,
                                 ledger)

    value = (aligned_list("value", np.dtype(np.float32))
             if "value" in names else None)
    field = aligned_list("field", index_dtype) if "field" in names else None
    weight = (_primitive_view(_one_chunk(table.column("weight"), "weight",
                                         ledger),
                              np.dtype(np.float32), "weight", ctx, ledger)
              if "weight" in names else None)
    return RowBlock(offsets, label, index, value, weight, field)


def _dense_block(table, index_dtype: np.dtype, label_column: int,
                 missing: float, ctx: str, ledger: _CopyLedger) -> RowBlock:
    names = table.column_names
    ncol = len(names)
    if 0 <= label_column < ncol:
        label_name = names[label_column]
    elif label_column < 0 and "label" in names:
        label_name = "label"
    else:
        label_name = None
    float32 = np.dtype(np.float32)
    nrow = table.num_rows
    if label_name is not None:
        label = _primitive_view(_one_chunk(table.column(label_name),
                                           label_name, ledger),
                                float32, label_name, ctx, ledger)
    else:
        label = np.zeros(nrow, dtype=float32)
    cols = [_primitive_view(_one_chunk(table.column(name), name, ledger),
                            float32, name, ctx, ledger, missing=missing)
            for name in names if name != label_name]
    nfeat = len(cols)
    if nfeat == 0:
        raise ArrowIngestError(f"{ctx}: dense schema has no feature columns")
    # CSR is row-major by definition: a dense columnar source always pays
    # exactly this one vectorized interleave (documented caveat; use the
    # sparse list schema for the pure-view path)
    ledger.bulk("<features>", f"dense row-major interleave of {nfeat} "
                "float32 columns into the CSR value array")
    value = np.stack(cols, axis=1).reshape(-1)
    index = np.tile(np.arange(nfeat, dtype=index_dtype), nrow)
    offset = np.arange(nrow + 1, dtype=np.int64) * nfeat
    return RowBlock(offset, label, index, value)


def table_to_block(table, index_dtype=np.uint32, label_column: int = -1,
                   missing: float = 0.0, ctx: str = "arrow",
                   ) -> Tuple[Optional[RowBlock], Dict[str, object]]:
    """Map one Arrow table onto a RowBlock without a parse stage.

    Schema is detected from the columns: any list-typed column selects the
    sparse (libsvm-shaped) mapping, otherwise every non-label float32
    column is a dense feature (CSV-shaped).  Returns ``(block, stats)``;
    ``block`` is None for an empty table (empty row groups are legal and
    skipped).  ``stats`` carries the zero-copy ledger for this block.
    """
    require_pyarrow()
    ledger = _CopyLedger(ctx)
    if table.num_rows == 0:
        return None, {"rows": 0, "nbytes": 0, "zero_copy_columns": 0,
                      "bulk_copy_columns": 0, "bulk_copy_reasons": []}
    if any(pa.types.is_list(f.type) or pa.types.is_large_list(f.type)
           for f in table.schema):
        if "index" not in table.column_names:
            raise ArrowIngestError(
                f"{ctx}: list-typed columns present but no 'index' column "
                "— the sparse schema is label + index[, value, weight, "
                f"field] (have {table.column_names})")
        block = _sparse_block(table, np.dtype(index_dtype), ctx, ledger)
    else:
        block = _dense_block(table, np.dtype(index_dtype), label_column,
                             missing, ctx, ledger)
    nbytes = sum(int(col.nbytes) for col in
                 (block.offset, block.label, block.weight, block.field,
                  block.index, block.value) if col is not None)
    return block, {"rows": block.size, "nbytes": nbytes,
                   "zero_copy_columns": ledger.zero_copy,
                   "bulk_copy_columns": ledger.bulk_copy,
                   "bulk_copy_reasons": ledger.bulk_reasons}


class _ColumnarParserBase(Parser):
    """Shared machinery for the columnar front doors.

    A columnar file is a footer-indexed sequence of *units* (Parquet row
    groups / Arrow IPC record batches); both formats shard by unit: part
    ``k`` of ``n`` reads units ``k, k+n, k+2n, …`` — deterministic,
    exactly-once coverage, no byte-range realignment because units are
    the format's own split points.  Local files are memory-mapped; remote
    URIs ride :class:`~dmlc_core_tpu_torch.io.ranged_read.RangedReadFile` —
    the footer and only the assigned units are ranged-read, the same
    open-by-footer discipline as the remote page cache.

    Construction is cheap and IO-free apart from the pyarrow gate; the
    file opens lazily on first use, so a warm page-cache run through
    ``DiskRowIter`` never pays footer traffic.
    """

    format_name = "?"

    def __init__(self, uri: str, args=None, part_index: int = 0,
                 num_parts: int = 1, index_dtype=np.uint32):
        require_pyarrow()
        args = dict(args or {})
        self._uri = uri
        self._index_dtype = np.dtype(index_dtype)
        self._label_column = int(args.get("label_column", -1))
        self._missing = float(args.get("missing", 0.0))
        self._part_index = part_index
        self._num_parts = max(1, num_parts)
        self._ranged = None
        self._opened = False
        self._units: List[int] = []
        self._pos = 0
        self._bytes_read = 0

    # -- per-format hooks -----------------------------------------------------
    def _open_local(self, path: str) -> int:
        """Open a local path (memory-mapped); return the unit count."""
        raise NotImplementedError

    def _open_file(self, fileobj) -> int:
        """Open a remote file-like (ranged reads); return the unit count."""
        raise NotImplementedError

    def _read_unit(self, unit: int):
        """One unit as an Arrow table."""
        raise NotImplementedError

    def _close_impl(self) -> None:
        raise NotImplementedError

    # -- Parser protocol ------------------------------------------------------
    def _open(self) -> None:
        if self._opened:
            return
        uri = self._uri
        with telemetry.span("ingest.arrow", uri=uri,
                            format=self.format_name) as sp:
            if "://" in uri and not uri.startswith("file://"):
                from dmlc_core_tpu_torch.io.ranged_read import RangedReadFile

                self._ranged = RangedReadFile(uri)
                try:
                    nunits = self._open_file(self._ranged)
                except BaseException:
                    # a bad footer must not orphan the open FS stream: the
                    # caller never gets the instance state to close()
                    ranged, self._ranged = self._ranged, None
                    ranged.close()
                    raise
            else:
                path = uri[7:] if uri.startswith("file://") else uri
                nunits = self._open_local(path)
            self._units = [u for u in range(nunits)
                           if u % self._num_parts == self._part_index]
            sp.set(units=len(self._units))
        self._opened = True
        self._pos = 0

    def before_first(self) -> None:
        self._open()
        self._pos = 0

    def next(self) -> Optional[RowBlock]:
        self._open()
        while self._pos < len(self._units):
            unit = self._units[self._pos]
            self._pos += 1
            with telemetry.span("ingest.arrow.block", unit=unit,
                                format=self.format_name) as sp:
                table = self._read_unit(unit)
                block, stats = table_to_block(
                    table, self._index_dtype, self._label_column,
                    self._missing,
                    ctx=f"{self._uri} {self.format_name} unit {unit}")
                sp.set(rows=stats["rows"], nbytes=stats["nbytes"])
            self._bytes_read += int(stats["nbytes"])
            if telemetry.enabled() and stats["rows"]:
                telemetry.count("dmlc_ingest_rows_total", stats["rows"],
                                format=self.format_name)
                telemetry.count("dmlc_ingest_bytes_total", stats["nbytes"],
                                format=self.format_name)
            if block is not None:
                return block
        return None

    def bytes_read(self) -> int:
        return self._bytes_read

    def close(self) -> None:
        try:
            self._close_impl()
        finally:
            self._opened = False
            if self._ranged is not None:
                self._ranged.close()
                self._ranged = None


class ParquetParser(_ColumnarParserBase):
    """Parser over Parquet row groups: columnar in, RowBlock views out.

    Parquet pages are *encoded* (def/rep levels, optional codec), so the
    read decodes into fresh Arrow buffers at C++ speed — still no text
    parse anywhere — and the Arrow->RowBlock boundary maps those buffers
    as views.  For the pure end-to-end mmap path use the Arrow IPC format
    (:class:`ArrowIPCParser`)."""

    format_name = "parquet"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pf = None

    def _open_local(self, path: str) -> int:
        self._pf = pq.ParquetFile(path, memory_map=True)
        return self._pf.num_row_groups

    def _open_file(self, fileobj) -> int:
        self._pf = pq.ParquetFile(fileobj)
        return self._pf.num_row_groups

    def _read_unit(self, unit: int):
        return self._pf.read_row_group(unit)

    def _close_impl(self) -> None:
        if self._pf is not None:
            try:
                self._pf.close()
            finally:
                self._pf = None


class ArrowIPCParser(_ColumnarParserBase):
    """Parser over Arrow IPC (feather v2) record batches.

    IPC *is* the Arrow memory layout on disk: a local file memory-maps and
    every batch is served as views over the mapping — no decode stage at
    all, the columnar analog of the v2 page cache's epoch>=2 replay.  A
    remote URI ranged-reads the footer and the assigned batches."""

    format_name = "arrow"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._reader = None
        self._mm = None

    def _open_local(self, path: str) -> int:
        self._mm = pa.memory_map(path)
        try:
            self._reader = pa.ipc.open_file(self._mm)
        except BaseException:
            mm, self._mm = self._mm, None
            mm.close()
            raise
        return self._reader.num_record_batches

    def _open_file(self, fileobj) -> int:
        self._reader = pa.ipc.open_file(fileobj)
        return self._reader.num_record_batches

    def _read_unit(self, unit: int):
        return pa.Table.from_batches([self._reader.get_batch(unit)])

    def _close_impl(self) -> None:
        self._reader = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BaseException:
                # live RowBlock views pin the mapping; pyarrow refuses to
                # unmap under exported buffers — GC reclaims it later,
                # exactly like PageCacheReader.close under live views
                pass
            self._mm = None
