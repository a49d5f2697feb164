"""Parser factory with format auto-detection from URI args.

Counterpart of ``dmlc_core_tpu/data/factory.py`` for the text formats the
port has (``libsvm``, ``csv``): registry-driven parser construction
(reference DMLC_REGISTER_DATA_PARSER, data.h:330-333) and ``format=``
auto-detection from the URI query string (data.cc:70-76, default libsvm).
``libfm``, the columnar formats and ``create_row_block_iter`` are not
ported yet and raise.
"""

from __future__ import annotations

import numpy as np

from dmlc_core_tpu_torch.data.csv_parser import CSVParser
from dmlc_core_tpu_torch.data.libsvm_parser import LibSVMParser
from dmlc_core_tpu_torch.data.parser import Parser, ThreadedParser
from dmlc_core_tpu_torch.io.input_split import create_input_split
from dmlc_core_tpu_torch.io.uri_spec import URISpec
from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.utils.logging import log_fatal

__all__ = ["create_parser", "create_row_block_iter", "parser_registry"]

parser_registry = Registry.get("data_parser")


@parser_registry.register("libsvm", description="label[:weight] idx[:val]... lines")
def _make_libsvm(source, args, nthread, index_dtype):
    return LibSVMParser(source, nthread=nthread, index_dtype=index_dtype)


@parser_registry.register("csv", description="dense csv rows")
def _make_csv(source, args, nthread, index_dtype):
    return CSVParser(source, args=args, nthread=nthread, index_dtype=index_dtype)


# formats of the JAX package still to port -> the ROADMAP item naming them
_NOT_PORTED = {"libfm": "the libfm parser", "parquet": "columnar ingest",
               "arrow": "columnar ingest", "feather": "columnar ingest",
               "ipc": "columnar ingest"}

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
    ``.parquet``/``.arrow``/``.feather`` path names a columnar format
    (not ported yet), anything else defaults to libsvm (reference
    data.cc:70-76).  The returned parser is wrapped in a
    :class:`ThreadedParser` prefetcher unless ``threaded=False``.
    """
    spec = URISpec(uri, part_index, num_parts)
    ptype = type
    if ptype == "auto":
        ext = "." + spec.uri.rsplit(".", 1)[-1] if "." in spec.uri else ""
        default = _COLUMNAR_EXTENSIONS.get(ext, "libsvm")
        ptype = spec.args.get("format", default)
    if ptype in _NOT_PORTED:
        log_fatal(f"parser format {ptype!r} is not yet in the PyTorch port "
                  f"(ROADMAP §1: {_NOT_PORTED[ptype]})")
    entry = parser_registry[ptype]
    split_uri = spec.uri + (f"#{spec.cache_file}" if spec.cache_file else "")
    source = create_input_split(split_uri, part_index, num_parts, "text")
    try:
        parser = entry(source, spec.args, nthread, np.dtype(index_dtype))
    except BaseException:
        source.close()      # its read-ahead thread would outlive the error
        raise
    if threaded:
        return ThreadedParser(parser)
    return parser


def create_row_block_iter(*args, **kwargs):
    """Not ported yet: it needs the row iterators and the page cache."""
    log_fatal("create_row_block_iter is not yet in the PyTorch port "
              "(ROADMAP §1: row iterators and the page cache)")
