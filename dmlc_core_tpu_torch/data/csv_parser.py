"""Dense CSV parser.

Capability parity with the reference (src/data/csv_parser.h:22-102):
- every column is a dense float feature; feature indices are renumbered
  sequentially over non-label columns (csv_parser.h:78-92);
- ``label_column`` (from URI args, e.g. ``data.csv?format=csv&label_column=0``)
  selects the label; default -1 means label 0.0 for every row;
- empty lines are skipped.

Counterpart of ``dmlc_core_tpu/data/csv_parser.py``, numpy path only.
"""

from __future__ import annotations

import numpy as np

from dmlc_core_tpu_torch.data.parser import TextParserBase
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_core_tpu_torch.param import Parameter, field
from dmlc_core_tpu_torch.utils.logging import CHECK_EQ

__all__ = ["CSVParser", "CSVParserParam"]


class CSVParserParam(Parameter):
    """Reference CSVParserParam (csv_parser.h:22-32)."""

    format = field(str, default="csv", help="File format.")
    label_column = field(int, default=-1,
                         help="Column index that will be put into the label.")
    missing = field(float, default=0.0,
                    help="Value for empty cells. 0.0 matches the reference "
                         "(its strtof parses an empty field as zero, "
                         "csv_parser.h:83); pass nan (?missing=nan) to mark "
                         "them missing for sparsity-aware GBDT training.")


class CSVParser(TextParserBase):
    def __init__(self, source, args=None, nthread: int = 2, index_dtype=np.uint32):
        super().__init__(source, nthread)
        self._index_dtype = np.dtype(index_dtype)
        # URI args the parameter does not declare are left to others
        self.param = CSVParserParam(**{k: v for k, v in (args or {}).items()
                                       if k in CSVParserParam.__fields__})
        CHECK_EQ(self.param.format, "csv")

    def _assemble(self, labels: np.ndarray,
                  feats: np.ndarray) -> RowBlockContainer:
        out = RowBlockContainer(self._index_dtype)
        nrow, nfeat = feats.shape
        if nrow == 0:
            return out
        index = np.tile(np.arange(nfeat, dtype=self._index_dtype), nrow)
        offset = np.arange(nrow + 1, dtype=np.int64) * nfeat
        out.push_block(RowBlock(offset, labels, index, feats.reshape(-1)))
        out.max_index = max(nfeat - 1, 0)
        return out

    def parse_block(self, data: bytes) -> RowBlockContainer:
        out = RowBlockContainer(self._index_dtype)
        rows = [r for r in data.splitlines() if r.strip()]
        if not rows:
            return out
        ncol = rows[0].count(b",") + 1
        flat = b",".join(rows).split(b",")
        CHECK_EQ(len(flat), len(rows) * ncol,
                 "CSV rows have inconsistent column counts")
        # empty cells take the configured missing value (reference parity:
        # its strtof parses an empty field as 0.0, csv_parser.h:83)
        fill = repr(float(self.param.missing)).encode()
        flat = [c if c.strip() else fill for c in flat]
        try:
            dense = np.array(flat).astype(np.float32).reshape(len(rows), ncol)
        except ValueError as exc:
            raise ValueError(f"invalid CSV number: {exc}") from None

        lc = self.param.label_column
        if 0 <= lc < ncol:
            labels = dense[:, lc]
            feats = np.delete(dense, lc, axis=1)
        else:
            labels = np.zeros(len(rows), dtype=np.float32)
            feats = dense
        return self._assemble(labels, feats)
