"""Parser factory with format auto-detection from URI args.

Counterpart of ``dmlc_core_tpu/data/factory.py``, with the same formats:
the text formats (``libsvm``, ``libfm``, ``csv``) and the columnar ones
(``parquet``, ``arrow``/``feather``/``ipc``, :mod:`.arrow_ingest`).
Registry-driven parser construction (reference DMLC_REGISTER_DATA_PARSER,
data.h:330-333) and ``format=`` auto-detection from the URI query string
(data.cc:70-76, default libsvm).  A ``#cachefile`` URI reads through the
cached split.  ``create_row_block_iter`` chooses in-memory or disk-cached
iteration by the presence of a ``#cachefile`` (data.cc:87-107).
"""

from __future__ import annotations

import numpy as np

from dmlc_core_tpu_torch.data.csv_parser import CSVParser
from dmlc_core_tpu_torch.data.iterators import BasicRowIter, DiskRowIter, RowBlockIter
from dmlc_core_tpu_torch.data.libfm_parser import LibFMParser
from dmlc_core_tpu_torch.data.libsvm_parser import LibSVMParser
from dmlc_core_tpu_torch.data.parser import Parser, ThreadedParser
from dmlc_core_tpu_torch.io.input_split import create_input_split
from dmlc_core_tpu_torch.io.uri_spec import URISpec
from dmlc_core_tpu_torch.registry import Registry

__all__ = ["create_parser", "create_row_block_iter", "parser_registry"]

parser_registry = Registry.get("data_parser")


@parser_registry.register("libsvm", description="label[:weight] idx[:val]... lines")
def _make_libsvm(source, args, nthread, index_dtype):
    return LibSVMParser(source, nthread=nthread, index_dtype=index_dtype)


@parser_registry.register("libfm", description="label field:idx:val... lines")
def _make_libfm(source, args, nthread, index_dtype):
    return LibFMParser(source, nthread=nthread, index_dtype=index_dtype)


@parser_registry.register("csv", description="dense csv rows")
def _make_csv(source, args, nthread, index_dtype):
    return CSVParser(source, args=args, nthread=nthread, index_dtype=index_dtype)


@parser_registry.register("parquet",
                          description="columnar Parquet row groups, "
                                      "zero-copy Arrow buffer -> RowBlock")
def _make_parquet(uri, args, part_index, num_parts, nthread, index_dtype):
    # lazy import: pyarrow is optional and its absence must only surface
    # when a columnar source is actually requested (the HDFS gating pattern)
    from dmlc_core_tpu_torch.data.arrow_ingest import ParquetParser

    return ParquetParser(uri, args=args, part_index=part_index,
                         num_parts=num_parts, index_dtype=index_dtype)


@parser_registry.register("arrow", aliases=["feather", "ipc"],
                          description="Arrow IPC record batches, mmap'd "
                                      "zero-copy views -> RowBlock")
def _make_arrow_ipc(uri, args, part_index, num_parts, nthread, index_dtype):
    from dmlc_core_tpu_torch.data.arrow_ingest import ArrowIPCParser

    return ArrowIPCParser(uri, args=args, part_index=part_index,
                          num_parts=num_parts, index_dtype=index_dtype)


# columnar formats consume the URI itself (footer + unit ranged reads)
# instead of a newline-oriented InputSplit; sharding is by row group /
# record batch
_make_parquet.takes_uri = True
_make_arrow_ipc.takes_uri = True

# extension -> format when neither type= nor ?format= names one
_COLUMNAR_EXTENSIONS = {".parquet": "parquet", ".arrow": "arrow",
                        ".feather": "arrow", ".ipc": "arrow"}


def create_parser(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "auto",
    nthread: int = 2,
    index_dtype=np.uint32,
    threaded: bool = True,
) -> Parser:
    """Create a parser (reference Parser<IndexType>::Create, src/data.cc:132-138).

    ``type="auto"`` reads ``?format=`` from the URI; a bare
    ``.parquet``/``.arrow``/``.feather`` path selects the columnar front
    door, anything else defaults to libsvm (reference data.cc:70-76).  The
    returned parser is wrapped in a :class:`ThreadedParser` prefetcher
    unless ``threaded=False``.
    """
    spec = URISpec(uri, part_index, num_parts)
    ptype = type
    if ptype == "auto":
        ext = "." + spec.uri.rsplit(".", 1)[-1] if "." in spec.uri else ""
        default = _COLUMNAR_EXTENSIONS.get(ext, "libsvm")
        ptype = spec.args.get("format", default)
    entry = parser_registry[ptype]
    if getattr(entry.body, "takes_uri", False):
        parser = entry(spec.uri, spec.args, part_index, num_parts, nthread,
                       np.dtype(index_dtype))
    else:
        split_uri = spec.uri + (f"#{spec.cache_file}" if spec.cache_file
                                else "")
        source = create_input_split(split_uri, part_index, num_parts, "text")
        try:
            parser = entry(source, spec.args, nthread, np.dtype(index_dtype))
        except BaseException:
            source.close()  # its read-ahead thread would outlive the error
            raise
    if threaded:
        return ThreadedParser(parser)
    return parser


def create_row_block_iter(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "auto",
    nthread: int = 2,
    index_dtype=np.uint32,
) -> RowBlockIter:
    """Create a RowBlockIter (reference RowBlockIter::Create, src/data.cc:87-129):
    ``uri#cachefile`` gives a :class:`DiskRowIter`, otherwise everything is
    loaded in memory (:class:`BasicRowIter`)."""
    spec = URISpec(uri, part_index, num_parts)
    parser_uri = spec.uri + ("?" + "&".join(f"{k}={v}" for k, v in spec.args.items())
                             if spec.args else "")
    if spec.cache_file:
        # lazily: a warm cache (local materialization or a fleet-shared
        # remote fetch) serves without ever constructing the parser or its
        # input split — no stream opens, no remote stat/list traffic
        return DiskRowIter(
            lambda: create_parser(parser_uri, part_index, num_parts, type,
                                  nthread, index_dtype),
            spec.cache_file, index_dtype=index_dtype)
    parser = create_parser(parser_uri, part_index, num_parts, type, nthread,
                           index_dtype)
    return BasicRowIter(parser, index_dtype=index_dtype)
