"""CSR sparse-batch data model.

Capability parity with the reference's ``dmlc::Row``/``RowBlock``
(include/dmlc/data.h:69-214) and ``RowBlockContainer``
(src/data/row_block.h:26-205), as numpy structure-of-arrays:

- ``offset``  int64[size+1] — CSR row pointers;
- ``label``   float32[size];
- ``weight``  float32[size] or None (None => all 1.0, data.h:120-125);
- ``field``   index_dtype[nnz] or None (libfm field ids);
- ``index``   index_dtype[nnz] — feature indices;
- ``value``   float32[nnz] or None (None => all values 1.0, data.h:106-112).

Binary save/load matches the reference's RowBlockContainer layout
(row_block.h:181-205): six u64-count-prefixed vectors then max_field/max_index
scalars, so caches interoperate with the C++ side.

Counterpart of ``dmlc_core_tpu/data/row_block.py`` (a copy).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_EQ, CHECK_LT

__all__ = ["Row", "RowBlock", "RowBlockContainer"]

real_t = np.float32


class Row:
    """One instance view into a RowBlock (reference Row, data.h:69-148)."""

    __slots__ = ("label", "weight", "field", "index", "value")

    def __init__(self, label, weight, field, index, value):
        self.label = label
        self.weight = weight
        self.field = field
        self.index = index
        self.value = value

    @property
    def length(self) -> int:
        return len(self.index)

    def get_value(self, i: int):
        return 1.0 if self.value is None else float(self.value[i])

    def get_weight(self):
        return 1.0 if self.weight is None else float(self.weight)

    def sdot(self, weights: np.ndarray) -> float:
        """Sparse dot with a dense vector (reference SDot, data.h:133-148)."""
        CHECK(self.index.size == 0 or int(self.index.max()) < len(weights),
              "feature index exceeds bound")
        if self.value is None:
            return float(weights[self.index].sum())
        return float(np.dot(weights[self.index], self.value))


class RowBlock:
    """A batch of rows in CSR layout (reference RowBlock, data.h:152-214)."""

    __slots__ = ("offset", "label", "weight", "field", "index", "value")

    def __init__(
        self,
        offset: np.ndarray,
        label: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
    ):
        self.offset = np.ascontiguousarray(offset, dtype=np.int64)
        self.label = np.ascontiguousarray(label, dtype=real_t)
        self.index = np.ascontiguousarray(index)
        self.value = None if value is None else np.ascontiguousarray(value, dtype=real_t)
        self.weight = None if weight is None else np.ascontiguousarray(weight, dtype=real_t)
        self.field = None if field is None else np.ascontiguousarray(field, dtype=self.index.dtype)
        CHECK_EQ(len(self.offset), len(self.label) + 1, "offset/label size mismatch")
        nnz = int(self.offset[-1] - self.offset[0])
        CHECK_EQ(len(self.index), nnz, "offset/index size mismatch")

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    def __len__(self) -> int:
        return self.size

    @property
    def num_nonzero(self) -> int:
        return int(self.offset[-1] - self.offset[0])

    def memory_cost_bytes(self) -> int:
        """Approximate memory cost (reference MemCostBytes, data.h:181-191)."""
        cost = self.size * (8 + 4)  # offset + label
        if self.weight is not None:
            cost += self.size * 4
        ndata = self.num_nonzero
        cost += ndata * self.index.dtype.itemsize
        if self.field is not None:
            cost += ndata * self.field.dtype.itemsize
        if self.value is not None:
            cost += ndata * 4
        return cost

    def __getitem__(self, i) -> "Row | RowBlock":
        if isinstance(i, slice):
            start, stop, step = i.indices(self.size)
            CHECK_EQ(step, 1, "RowBlock slices must be contiguous")
            return self.slice(start, stop)
        CHECK_LT(i, self.size, "row index out of range")
        lo = int(self.offset[i] - self.offset[0])
        hi = int(self.offset[i + 1] - self.offset[0])
        return Row(
            float(self.label[i]),
            None if self.weight is None else float(self.weight[i]),
            None if self.field is None else self.field[lo:hi],
            self.index[lo:hi],
            None if self.value is None else self.value[lo:hi],
        )

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Zero-copy sub-batch (reference Slice, data.h:198-213)."""
        CHECK(0 <= begin <= end <= self.size, "invalid slice range")
        lo = int(self.offset[begin] - self.offset[0])
        hi = int(self.offset[end] - self.offset[0])
        out = RowBlock.__new__(RowBlock)
        out.offset = self.offset[begin:end + 1]
        out.label = self.label[begin:end]
        out.weight = None if self.weight is None else self.weight[begin:end]
        out.field = None if self.field is None else self.field[lo:hi]
        out.index = self.index[lo:hi]
        out.value = None if self.value is None else self.value[lo:hi]
        return out

    def rows(self) -> Iterator[Row]:
        for i in range(self.size):
            yield self[i]


class RowBlockContainer:
    """Growable CSR builder with binary save/load
    (reference src/data/row_block.h:26-205)."""

    def __init__(self, index_dtype=np.uint32):
        self.index_dtype = np.dtype(index_dtype)
        self.offset: List[int] = [0]
        self.label: List[float] = []
        self.weight: List[float] = []
        self.field: List[int] = []
        self.index: List[int] = []
        self.value: List[float] = []
        self.max_field = 0
        self.max_index = 0
        # bulk numpy staging (fast path used by the vectorized parsers)
        self._np_chunks: List[RowBlock] = []

    # -- push API (reference Push(Row) row_block.h:87, Push(RowBlock) 119) ----
    def push_row(self, label: float, index: Sequence[int],
                 value: Optional[Sequence[float]] = None,
                 weight: Optional[float] = None,
                 field: Optional[Sequence[int]] = None) -> None:
        self.label.append(float(label))
        if weight is not None:
            self.weight.append(float(weight))
        self.index.extend(int(i) for i in index)
        if index:
            self.max_index = max(self.max_index, max(int(i) for i in index))
        if value is not None:
            self.value.extend(float(v) for v in value)
        if field is not None:
            self.field.extend(int(f) for f in field)
            if field:
                self.max_field = max(self.max_field, max(int(f) for f in field))
        self.offset.append(self.offset[-1] + len(index))

    def push_block(self, block: RowBlock) -> None:
        """Append a whole RowBlock (bulk, numpy-speed)."""
        self._np_chunks.append(block)

    @property
    def size(self) -> int:
        return len(self.offset) - 1 + sum(b.size for b in self._np_chunks)

    def clear(self) -> None:
        self.__init__(self.index_dtype)

    # -- materialize ----------------------------------------------------------
    def get_block(self) -> RowBlock:
        """Materialize as an immutable RowBlock (reference GetBlock, 162-180)."""
        blocks: List[RowBlock] = []
        if len(self.offset) > 1:
            blocks.append(RowBlock(
                np.asarray(self.offset, dtype=np.int64),
                np.asarray(self.label, dtype=real_t),
                np.asarray(self.index, dtype=self.index_dtype),
                np.asarray(self.value, dtype=real_t) if self.value else None,
                np.asarray(self.weight, dtype=real_t) if self.weight else None,
                np.asarray(self.field, dtype=self.index_dtype) if self.field else None,
            ))
        blocks.extend(self._np_chunks)
        if not blocks:
            return RowBlock(np.zeros(1, np.int64), np.zeros(0, real_t),
                            np.zeros(0, self.index_dtype))
        if len(blocks) == 1:
            return blocks[0]
        return concat_blocks(blocks)

    # -- binary IO (reference Save/Load, row_block.h:181-205) -----------------
    def save(self, stream: Stream) -> None:
        block = self.get_block()
        nnz = block.num_nonzero
        stream.write_array(np.asarray(block.offset - block.offset[0], dtype=np.uint64))
        stream.write_array(block.label)
        stream.write_array(block.weight if block.weight is not None
                           else np.zeros(0, real_t))
        stream.write_array(block.field if block.field is not None
                           else np.zeros(0, self.index_dtype))
        stream.write_array(np.asarray(block.index, dtype=self.index_dtype))
        stream.write_array(block.value if block.value is not None
                           else np.zeros(0, real_t))
        max_field = self.max_field or (int(block.field.max()) if
                                       (block.field is not None and nnz) else 0)
        max_index = self.max_index or (int(block.index.max()) if nnz else 0)
        stream.write(np.asarray([max_field, max_index], dtype=self.index_dtype).tobytes())

    def load(self, stream: Stream) -> bool:
        """Load one container; False at end of stream (reference Load)."""
        probe = stream.read(8)
        if len(probe) == 0:
            return False
        CHECK_EQ(len(probe), 8, "bad RowBlock format")
        n_offset = int(np.frombuffer(probe, dtype="<u8")[0])
        offset = np.frombuffer(stream.read_exact(8 * n_offset), dtype="<u8")
        label = stream.read_array(real_t)
        weight = stream.read_array(real_t)
        field = stream.read_array(self.index_dtype)
        index = stream.read_array(self.index_dtype)
        value = stream.read_array(real_t)
        tail = np.frombuffer(stream.read_exact(2 * self.index_dtype.itemsize),
                             dtype=self.index_dtype)
        self.clear()
        self._np_chunks = [RowBlock(
            offset.astype(np.int64), label, index,
            value if value.size else None,
            weight if weight.size else None,
            field if field.size else None,
        )]
        self.max_field, self.max_index = int(tail[0]), int(tail[1])
        return True


def concat_blocks(blocks: List[RowBlock]) -> RowBlock:
    """Concatenate RowBlocks into one (bulk path of Push(RowBlock))."""
    CHECK(len(blocks) > 0, "concat_blocks needs at least one block")
    offsets = [np.asarray(b.offset, dtype=np.int64) - int(b.offset[0]) for b in blocks]
    shifts = np.cumsum([0] + [int(o[-1]) for o in offsets[:-1]])
    offset = np.concatenate(
        [offsets[0]] + [o[1:] + s for o, s in zip(offsets[1:], shifts[1:])])
    label = np.concatenate([b.label for b in blocks])
    index = np.concatenate([b.index for b in blocks])
    any_value = any(b.value is not None for b in blocks)
    any_weight = any(b.weight is not None for b in blocks)
    any_field = any(b.field is not None for b in blocks)
    value = np.concatenate(
        [b.value if b.value is not None else np.ones(b.num_nonzero, real_t)
         for b in blocks]) if any_value else None
    weight = np.concatenate(
        [b.weight if b.weight is not None else np.ones(b.size, real_t)
         for b in blocks]) if any_weight else None
    field = np.concatenate(
        [b.field if b.field is not None else np.zeros(b.num_nonzero, b.index.dtype)
         for b in blocks]) if any_field else None
    return RowBlock(offset, label, index, value, weight, field)
