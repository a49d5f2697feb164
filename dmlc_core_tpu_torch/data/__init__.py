"""Data layer of the PyTorch port: RowBlocks, the libsvm/libfm/CSV text
parsers, the row iterators and the parser factory.

Counterpart of ``dmlc_core_tpu/data``, with the same exports.  It imports
no torch (a spawned parse worker of :mod:`.parse_proc` imports this
package); the columnar front door (:mod:`.arrow_ingest`, pyarrow) is
imported by the factory when a Parquet or Arrow source is asked for.
"""

from dmlc_core_tpu_torch.data.row_block import Row, RowBlock, RowBlockContainer  # noqa: F401
from dmlc_core_tpu_torch.data.parser import Parser, ParserImpl, ThreadedParser  # noqa: F401
from dmlc_core_tpu_torch.data.libsvm_parser import LibSVMParser  # noqa: F401
from dmlc_core_tpu_torch.data.libfm_parser import LibFMParser  # noqa: F401
from dmlc_core_tpu_torch.data.csv_parser import CSVParser, CSVParserParam  # noqa: F401
from dmlc_core_tpu_torch.data.iterators import BasicRowIter, DiskRowIter  # noqa: F401
from dmlc_core_tpu_torch.data.factory import create_parser, create_row_block_iter  # noqa: F401
