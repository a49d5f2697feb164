"""LibFM text parser: ``label field:idx:val ...`` per line.

Capability parity with the reference (src/data/libfm_parser.h): feature tokens
are ``field:index:value`` triples (ParseTriple, strtonum.h:265+); the label
token may carry a ``:weight``.

Counterpart of ``dmlc_core_tpu/data/libfm_parser.py``.  The native engine
parses a whole chunk in C++ (``parse_chunk_native``); the numpy engine is
vectorized on the shared byte-level tokenizer (two chained colon-split
gathers resolve the triples).
"""

from __future__ import annotations

import numpy as np

from dmlc_core_tpu_torch import native_bridge
from dmlc_core_tpu_torch.data.parser import TextParserBase
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_core_tpu_torch.data import text_np
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["LibFMParser"]


class LibFMParser(TextParserBase):
    def __init__(self, source, nthread: int = 2, index_dtype=np.uint32):
        super().__init__(source, nthread)
        self._index_dtype = np.dtype(index_dtype)

    def parse_chunk_native(self, data):
        offset, label, weight, index, field, value = native_bridge.parse_libfm(
            data, nthread=max(self._nthread, 2))
        out = RowBlockContainer(self._index_dtype)
        if len(label):
            out.push_block(RowBlock(offset, label,
                                    index.astype(self._index_dtype, copy=False),
                                    value, weight,
                                    field.astype(self._index_dtype, copy=False)))
            if index.size:
                out.max_index = int(index.max())
            if field.size:
                out.max_field = int(field.max())
        return out

    def parse_block(self, data: bytes) -> RowBlockContainer:
        out = RowBlockContainer(self._index_dtype)
        tokens, counts = text_np.tokenize_ws(data)
        if counts.size == 0:
            return out
        starts = np.cumsum(counts) - counts
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
        CHECK(bool(has_colon[feat_mask].all()),
              "libfm features must be field:index:value triples")
        field = text_np.parse_ints(head[feat_mask], self._index_dtype, "field id")
        rest = tail[feat_mask]
        mid, mid_colon, val_tok = text_np.split_tokens_at_colon(rest)
        CHECK(bool(mid_colon.all()) or mid.size == 0,
              "libfm features must be field:index:value triples")
        index = text_np.parse_ints(mid, self._index_dtype, "feature index")
        value = text_np.parse_floats(val_tok, "feature value")

        nnz = counts - 1
        offset = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(nnz, out=offset[1:])
        out.push_block(RowBlock(offset, labels, index, value, weight, field))
        if index.size:
            out.max_index = int(index.max())
        if field.size:
            out.max_field = int(field.max())
        return out
