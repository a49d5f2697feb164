"""LibSVM text parser: ``label[:weight] idx[:val] idx[:val] ...`` per line.

Capability parity with the reference (src/data/libsvm_parser.h:22-90):
- label token may carry a weight after ``:``;
- feature tokens are ``index[:value]``; a bare index means value 1.0 (the
  value vector stays empty when *no* token has a value);
- empty lines are skipped.

Counterpart of ``dmlc_core_tpu/data/libsvm_parser.py``, numpy path only.
Vectorized: whole-chunk byte-array tokenization + one colon-split gather +
bulk ``astype`` per chunk sub-range (:mod:`dmlc_core_tpu_torch.data.text_np`).
"""

from __future__ import annotations

import numpy as np

from dmlc_core_tpu_torch.data.parser import TextParserBase
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_core_tpu_torch.data import text_np

__all__ = ["LibSVMParser"]


class LibSVMParser(TextParserBase):
    def __init__(self, source, nthread: int = 2, index_dtype=np.uint32):
        super().__init__(source, nthread)
        self._index_dtype = np.dtype(index_dtype)

    def parse_block(self, data: bytes) -> RowBlockContainer:
        out = RowBlockContainer(self._index_dtype)
        tokens, counts = text_np.tokenize_ws(data)
        if counts.size == 0:
            return out
        starts = np.cumsum(counts) - counts           # first-token offset per line
        head, has_colon, tail = text_np.split_tokens_at_colon(tokens)

        labels = text_np.parse_floats(head[starts], "label")
        head_colon = has_colon[starts]
        weight = None
        if head_colon.any():
            weight = np.ones(len(labels), dtype=np.float32)
            weight[head_colon] = text_np.parse_floats(
                tail[starts[head_colon]], "weight")

        feat_mask = np.ones(len(tokens), dtype=bool)
        feat_mask[starts] = False
        index = text_np.parse_ints(head[feat_mask], self._index_dtype,
                                   "feature index")
        feat_colon = has_colon[feat_mask]
        if feat_colon.all():
            value = text_np.parse_floats(tail[feat_mask], "feature value")
        elif not feat_colon.any():
            value = None                               # implicit 1.0 values
        else:
            value = np.ones(len(index), dtype=np.float32)
            sel = np.nonzero(feat_mask)[0][feat_colon]
            value[feat_colon] = text_np.parse_floats(tail[sel], "feature value")

        nnz = counts - 1
        offset = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(nnz, out=offset[1:])
        out.push_block(RowBlock(offset, labels, index, value, weight))
        if index.size:
            out.max_index = int(index.max())
        return out
