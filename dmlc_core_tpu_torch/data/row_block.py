"""CSR row blocks — the tabular data contract.

Reference parity: ``include/dmlc/data.h :: Row<I>, RowBlock<I>`` (CSR arrays
offset/label/weight/qid/field/index/value, slice) and ``src/data/row_block.h
:: RowBlockContainer<I>`` (Push/GetBlock/Clear/Save/Load/max_index)
(SURVEY.md §2a-b).

Where the reference stores C++ vectors, a RowBlock here is a bundle of
**contiguous numpy arrays** — zero-copy views into parser output, ready for
``torch.from_numpy`` and the device upload.  The binary page format
(``save``/``load``) is the external-memory cache format used by
``DiskRowIter``.

This package's own copy of ``dmlc_core_tpu.data.row_block`` (the same page
bytes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK_EQ, CHECK_LE
from dmlc_core_tpu_torch.io import serializer as ser
from dmlc_core_tpu_torch.io.stream import Serializable, Stream

__all__ = ["Row", "RowBlock", "RowBlockContainer"]


@dataclass
class Row:
    """One sparse row view.  Reference: ``dmlc::Row<IndexType, DType>``."""

    label: float
    index: np.ndarray
    value: Optional[np.ndarray]  # None → all ones (binary features)
    weight: float = 1.0
    qid: int = 0
    field: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.index)

    def get_value(self, i: int) -> float:
        return 1.0 if self.value is None else float(self.value[i])

    def sdot(self, weights: np.ndarray) -> float:
        """Sparse dot with a dense weight vector.  Reference: ``Row::SDot``."""
        if self.value is None:
            return float(weights[self.index].sum())
        return float(np.dot(weights[self.index], self.value))


class RowBlock:
    """A block of sparse rows in CSR form.

    Arrays: ``offset`` int64[n+1]; ``label`` float32[n]; optional ``weight``
    float32[n], ``qid`` int64[n], ``field`` int32[nnz]; ``index`` int64[nnz];
    optional ``value`` float32[nnz] (None → implicit ones).
    """

    def __init__(
        self,
        offset: np.ndarray,
        label: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
    ):
        self.offset = np.ascontiguousarray(offset, dtype=np.int64)
        self.label = np.ascontiguousarray(label, dtype=np.float32)
        self.index = np.ascontiguousarray(index, dtype=np.int64)
        self.value = None if value is None else np.ascontiguousarray(value, dtype=np.float32)
        self.weight = None if weight is None else np.ascontiguousarray(weight, dtype=np.float32)
        self.qid = None if qid is None else np.ascontiguousarray(qid, dtype=np.int64)
        self.field = None if field is None else np.ascontiguousarray(field, dtype=np.int32)
        n = len(self.label)
        CHECK_EQ(len(self.offset), n + 1, "RowBlock: offset size mismatch")
        nnz = int(self.offset[-1])
        CHECK_EQ(len(self.index), nnz, "RowBlock: index size mismatch")
        if self.value is not None:
            CHECK_EQ(len(self.value), nnz, "RowBlock: value size mismatch")

    @property
    def size(self) -> int:
        return len(self.label)

    @property
    def nnz(self) -> int:
        return int(self.offset[-1])

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: Union[int, slice]) -> Union[Row, "RowBlock"]:
        if isinstance(i, slice):
            start, stop, step = i.indices(self.size)
            CHECK_EQ(step, 1, "RowBlock slices must be contiguous")
            return self.slice(start, stop)
        if i < 0:
            i += self.size
        lo, hi = int(self.offset[i]), int(self.offset[i + 1])
        return Row(
            label=float(self.label[i]),
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=1.0 if self.weight is None else float(self.weight[i]),
            qid=0 if self.qid is None else int(self.qid[i]),
            field=None if self.field is None else self.field[lo:hi],
        )

    def __iter__(self) -> Iterator[Row]:
        for i in range(self.size):
            yield self[i]  # type: ignore[misc]

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Zero-copy contiguous row range.  Reference: ``RowBlock::Slice``."""
        CHECK_LE(begin, end)
        CHECK_LE(end, self.size)
        lo, hi = int(self.offset[begin]), int(self.offset[end])
        return RowBlock(
            offset=self.offset[begin : end + 1] - lo,
            label=self.label[begin:end],
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=None if self.weight is None else self.weight[begin:end],
            qid=None if self.qid is None else self.qid[begin:end],
            field=None if self.field is None else self.field[lo:hi],
        )

    @property
    def max_index(self) -> int:
        return int(self.index.max()) if len(self.index) else 0

    def memory_cost(self) -> int:
        """Approximate bytes held (reference: ``RowBlock::MemCostBytes``)."""
        total = self.offset.nbytes + self.label.nbytes + self.index.nbytes
        for arr in (self.value, self.weight, self.qid, self.field):
            if arr is not None:
                total += arr.nbytes
        return total

    def to_dense(self, num_col: Optional[int] = None) -> np.ndarray:
        """Densify to float32 [n, num_col] (missing → 0)."""
        ncol = num_col if num_col is not None else self.max_index + 1
        # np.empty, not zeros: to_dense_into zero-fills each chunk
        # itself, so zeros here would write every byte twice
        out = np.empty((self.size, ncol), dtype=np.float32)
        self.to_dense_into(out)
        return out

    def to_dense_into(self, out: np.ndarray,
                      chunk_rows: int = 1 << 20) -> None:
        """Scatter this block into a preallocated float32 ``[size, F]``
        array in bounded row chunks.

        For a whole-dataset block (BasicRowIter slurps everything into
        one RowBlock) ``to_dense`` would build nnz-sized scatter
        temporaries for the full dataset at once; chunking bounds the
        transient to ``chunk_rows`` worth regardless of block size —
        the consumer (e.g. GBLinear.fit_iter) writes straight into its
        slice of one preallocated matrix."""
        CHECK_EQ(out.shape[0], self.size, "to_dense_into: row mismatch")
        for s in range(0, self.size, chunk_rows):
            e = min(s + chunk_rows, self.size)
            o0, o1 = int(self.offset[s]), int(self.offset[e])
            rows = np.repeat(np.arange(e - s),
                             np.diff(self.offset[s:e + 1]))
            sl = out[s:e]
            sl.fill(0.0)
            vals = (self.value[o0:o1] if self.value is not None
                    else np.ones(o1 - o0, np.float32))
            sl[rows, self.index[o0:o1]] = vals


class RowBlockContainer(Serializable):
    """Growable CSR builder with binary page (de)serialization.

    Reference parity: ``src/data/row_block.h :: RowBlockContainer<I>`` —
    this is the external-memory cache-file format.
    """

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self._offsets: List[int] = [0]
        self._labels: List[float] = []
        self._weights: List[float] = []
        self._qids: List[int] = []
        self._index_chunks: List[np.ndarray] = []
        self._value_chunks: List[Optional[np.ndarray]] = []
        self._field_chunks: List[Optional[np.ndarray]] = []
        self._nnz = 0
        self.max_index = 0
        # column presence is schema, not data: a weight column of all 1.0s
        # must survive the cache round trip as a present column
        self._has_weight = False
        self._has_qid = False

    @property
    def size(self) -> int:
        return len(self._labels)

    def __len__(self) -> int:
        return self.size

    def push(
        self,
        label: float,
        index: Sequence[int],
        value: Optional[Sequence[float]] = None,
        weight: Optional[float] = None,
        qid: Optional[int] = None,
        field: Optional[Sequence[int]] = None,
    ) -> None:
        """Append one row.  Reference: ``RowBlockContainer::Push(Row)``.

        ``weight``/``qid`` of None mean "column absent" (defaults 1.0 / 0
        are substituted if other rows establish the column).
        """
        idx = np.asarray(index, dtype=np.int64)
        self._index_chunks.append(idx)
        self._value_chunks.append(
            None if value is None else np.asarray(value, dtype=np.float32)
        )
        self._field_chunks.append(
            None if field is None else np.asarray(field, dtype=np.int32)
        )
        self._nnz += len(idx)
        self._offsets.append(self._nnz)
        self._labels.append(float(label))
        self._weights.append(1.0 if weight is None else float(weight))
        self._qids.append(0 if qid is None else int(qid))
        self._has_weight |= weight is not None
        self._has_qid |= qid is not None
        if len(idx):
            self.max_index = max(self.max_index, int(idx.max()))

    def push_block(self, block: RowBlock) -> None:
        """Append a whole RowBlock (bulk path used by parsers)."""
        self._index_chunks.append(block.index)
        self._value_chunks.append(block.value)
        self._field_chunks.append(block.field)
        base = self._nnz
        self._nnz += block.nnz
        self._offsets.extend((block.offset[1:] + base).tolist())
        self._labels.extend(block.label.tolist())
        w = block.weight if block.weight is not None else np.ones(block.size, np.float32)
        self._weights.extend(w.tolist())
        q = block.qid if block.qid is not None else np.zeros(block.size, np.int64)
        self._qids.extend(q.tolist())
        self._has_weight |= block.weight is not None
        self._has_qid |= block.qid is not None
        if block.nnz:
            self.max_index = max(self.max_index, block.max_index)

    def to_block(self) -> RowBlock:
        """Materialize the accumulated rows.  Reference: ``GetBlock``."""
        nnz = self._nnz
        index = (
            np.concatenate(self._index_chunks)
            if self._index_chunks
            else np.empty(0, np.int64)
        )
        has_value = any(v is not None for v in self._value_chunks)
        value = None
        if has_value:
            value = np.concatenate(
                [
                    v if v is not None else np.ones(len(i), np.float32)
                    for v, i in zip(self._value_chunks, self._index_chunks)
                ]
            ) if self._value_chunks else np.empty(0, np.float32)
        has_field = any(f is not None for f in self._field_chunks)
        field = None
        if has_field:
            field = np.concatenate(
                [
                    f if f is not None else np.zeros(len(i), np.int32)
                    for f, i in zip(self._field_chunks, self._index_chunks)
                ]
            )
        return RowBlock(
            offset=np.asarray(self._offsets, dtype=np.int64),
            label=np.asarray(self._labels, dtype=np.float32),
            index=index,
            value=value,
            weight=np.asarray(self._weights, np.float32) if self._has_weight else None,
            qid=np.asarray(self._qids, np.int64) if self._has_qid else None,
            field=field,
        )

    # -- binary page format (the disk-cache format) ----------------------
    _PAGE_MAGIC = 0xD317B10C

    def save(self, stream: Stream) -> None:
        block = self.to_block()
        ser.write_uint32(stream, self._PAGE_MAGIC)
        flags = (
            (1 if block.value is not None else 0)
            | (2 if block.weight is not None else 0)
            | (4 if block.qid is not None else 0)
            | (8 if block.field is not None else 0)
        )
        ser.write_uint32(stream, flags)
        ser.write_uint64(stream, self.max_index)
        ser.write_ndarray(stream, block.offset)
        ser.write_ndarray(stream, block.label)
        ser.write_ndarray(stream, block.index)
        for arr in (block.value, block.weight, block.qid, block.field):
            if arr is not None:
                ser.write_ndarray(stream, arr)

    def load(self, stream: Stream) -> bool:
        """Load one page; returns False on clean EOF."""
        head = stream.read(4)
        if len(head) == 0:
            return False
        CHECK_EQ(len(head), 4, "RowBlockContainer: truncated page header")
        magic = int.from_bytes(head, "little")
        CHECK_EQ(magic, self._PAGE_MAGIC, "RowBlockContainer: bad page magic")
        flags = ser.read_uint32(stream)
        max_index = ser.read_uint64(stream)
        offset = ser.read_ndarray(stream)
        label = ser.read_ndarray(stream)
        index = ser.read_ndarray(stream)
        value = ser.read_ndarray(stream) if flags & 1 else None
        weight = ser.read_ndarray(stream) if flags & 2 else None
        qid = ser.read_ndarray(stream) if flags & 4 else None
        field = ser.read_ndarray(stream) if flags & 8 else None
        self.clear()
        self.push_block(
            RowBlock(offset, label, index, value=value, weight=weight, qid=qid, field=field)
        )
        self.max_index = int(max_index)
        return True
