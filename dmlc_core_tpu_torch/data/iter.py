"""Row-block iterators: in-memory and external-memory (disk-cached).

Reference parity: ``include/dmlc/data.h :: RowBlockIter<I>::Create``,
``src/data/basic_row_iter.h :: BasicRowIter`` (slurp whole input),
``src/data/disk_row_iter.h :: DiskRowIter`` (parse once → binary pages on a
cache file → prefetch-iterate pages) (SURVEY.md §2b).

A ``#cachefile`` suffix on the URI selects the external-memory path, exactly
like the reference (``RowBlockIter::Create("big.libsvm#cache.bin", ...)``):
pass 1 streams parser output into RowBlockContainer pages on the cache URI;
later epochs replay pages through a ThreadedIter so storage read overlaps
consumption.

This package's own copy of ``dmlc_core_tpu.data.iter`` (host numpy; held
to the JAX package's own tests), with the sharded-ingest slab math
(``slab_shard_slices``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.data.parsers import Parser, parse_uri_spec
from dmlc_core_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_core_tpu_torch.utils.profiler import global_tracer, tracing_enabled

__all__ = ["RowBlockIter", "BasicRowIter", "DiskRowIter", "ArrayRowIter",
           "iter_dense_slabs", "iter_csr_minibatches", "slab_shard_slices"]

# target bytes per cache page (reference uses a row-count heuristic; byte
# budget maps better to fixed host-staging buffers)
_PAGE_BYTES = 64 << 20

_DM = None


def _data_metrics():
    """``path="build"`` counts the pass-1 parse→cache write; ``"replay"``
    counts cache-hit page reads on later epochs — the external-memory
    question (is this run paying the parse again?) answered by two
    counters."""
    global _DM
    if _DM is None:
        r = _metrics.default_registry()
        _DM = {
            "pages": r.counter("data_pages_total",
                               "row-block pages through DiskRowIter",
                               labels=("path",)),
            "rows": r.counter("data_page_rows_total",
                              "rows through DiskRowIter pages",
                              labels=("path",)),
            "build_s": r.histogram("data_cache_build_seconds",
                                   "DiskRowIter pass-1 cache build time"),
        }
    return _DM


class RowBlockIter:
    """Iterator over CSR RowBlocks with rewind.

    Reference: ``dmlc::RowBlockIter<IndexType>`` (DataIter contract:
    before_first / next / value).
    """

    @staticmethod
    def create(uri: str, part: int = 0, nparts: int = 1,
               format: Optional[str] = None, nthread: int = 0) -> "RowBlockIter":
        """``#cachefile`` in the URI → external-memory DiskRowIter, else
        in-memory BasicRowIter.  Reference: ``src/data.cc :: CreateIter_``."""
        _path, _args, cache = parse_uri_spec(uri)
        parser = Parser.create(uri, part, nparts, format, nthread)
        if cache:
            return DiskRowIter(parser, cache + (f".part{part}" if nparts > 1 else ""))
        return BasicRowIter(parser)

    # -- DataIter contract ----------------------------------------------
    def before_first(self) -> None:
        raise NotImplementedError

    def next_block(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RowBlock]:
        self.before_first()
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block

    @property
    def num_col(self) -> int:
        raise NotImplementedError

    @property
    def num_rows(self) -> Optional[int]:
        """Total rows, when known without a decode pass (None otherwise).
        Consumers sizing a preallocation (GBLinear.fit_iter) use this to
        avoid re-reading the whole input just to count."""
        return None

    def close(self) -> None:
        pass


class BasicRowIter(RowBlockIter):
    """Slurp the whole parser output into one block at construction.

    Reference: ``basic_row_iter.h`` — the small-data path.
    """

    def __init__(self, parser: Parser):
        container = RowBlockContainer()
        for block in parser:
            container.push_block(block)
        parser.close()
        self._block = container.to_block()
        self._max_index = container.max_index
        self._done = False

    def before_first(self) -> None:
        self._done = False

    def next_block(self) -> Optional[RowBlock]:
        if self._done:
            return None
        self._done = True
        return self._block

    @property
    def value(self) -> RowBlock:
        return self._block

    @property
    def num_col(self) -> int:
        return self._max_index + 1

    @property
    def num_rows(self) -> int:
        return self._block.size


class ArrayRowIter(RowBlockIter):
    """In-memory dense arrays as a rewindable :class:`RowBlockIter`.

    The adapter the elastic recovery layer uses to re-cut row shards
    over a changing world: ``ArrayRowIter(X[lo:hi], y[lo:hi])`` turns
    any contiguous row range into the page-stream contract
    ``fit_external`` consumes, without a serialization round trip.
    Pages are CSR views of ``page_rows`` rows each (dense: every entry
    present, so zeros stay explicit and bin identically to the
    densified parser path).
    """

    def __init__(self, X, y, weight=None, page_rows: int = 65536):
        X = np.ascontiguousarray(X, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float32)
        n, F = X.shape
        self._ncol = F
        self._pages = []
        for lo in range(0, max(n, 1), page_rows):
            hi = min(lo + page_rows, n)
            rows = hi - lo
            self._pages.append(RowBlock(
                offset=np.arange(rows + 1, dtype=np.int64) * F,
                label=y[lo:hi],
                index=np.tile(np.arange(F, dtype=np.int64), rows),
                value=X[lo:hi].reshape(-1),
                weight=None if weight is None else np.ascontiguousarray(
                    weight[lo:hi], dtype=np.float32),
            ))
        self._n = n
        self._pos = 0

    def before_first(self) -> None:
        self._pos = 0

    def next_block(self) -> Optional[RowBlock]:
        if self._pos >= len(self._pages):
            return None
        block = self._pages[self._pos]
        self._pos += 1
        return block

    @property
    def num_col(self) -> int:
        return self._ncol

    @property
    def num_rows(self) -> int:
        return self._n


class DiskRowIter(RowBlockIter):
    """Parse once to binary pages on a cache URI; iterate pages with
    prefetch.  Reference: ``disk_row_iter.h`` — the external-memory path
    (ancestor of XGBoost external memory)."""

    def __init__(self, parser: Parser, cache_uri: str, page_bytes: int = _PAGE_BYTES):
        self._cache_uri = cache_uri
        self._max_index = 0
        self._num_pages = 0
        self._num_rows = 0
        self._build_cache(parser, page_bytes)
        self._iter: Optional[ThreadedIter] = None
        self._read_stream: Optional[Stream] = None

    def _build_cache(self, parser: Parser, page_bytes: int) -> None:
        t0 = get_time()
        ctx = (global_tracer().scope("disk_row_iter.build_cache",
                                     cache=self._cache_uri)
               if tracing_enabled() else contextlib.nullcontext())
        with ctx:
            out = Stream.create(self._cache_uri, "w")
            container = RowBlockContainer()
            held = 0
            for block in parser:
                container.push_block(block)
                self._num_rows += block.size
                held += block.memory_cost()
                if held >= page_bytes:
                    container.save(out)
                    self._num_pages += 1
                    self._max_index = max(self._max_index, container.max_index)
                    container.clear()
                    held = 0
            if container.size:
                container.save(out)
                self._num_pages += 1
                self._max_index = max(self._max_index, container.max_index)
            out.close()
            parser.close()
        if _metrics.enabled():
            m = _data_metrics()
            m["pages"].inc(self._num_pages, path="build")
            m["rows"].inc(self._num_rows, path="build")
            m["build_s"].observe(get_time() - t0)

    def _start_reader(self) -> None:
        self._stop_reader()
        self._read_stream = Stream.create(self._cache_uri, "r")

        def next_page(_cell) -> Optional[RowBlock]:
            container = RowBlockContainer()
            if not container.load(self._read_stream):
                return None
            block = container.to_block()
            if _metrics.enabled():
                m = _data_metrics()
                m["pages"].inc(1, path="replay")
                m["rows"].inc(block.size, path="replay")
            return block

        def rewind() -> None:
            self._read_stream.close()
            self._read_stream = Stream.create(self._cache_uri, "r")

        self._iter = ThreadedIter(max_capacity=2, name="disk_row_iter")
        self._iter.init(next_page, rewind)

    def _stop_reader(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None
        if self._read_stream is not None:
            self._read_stream.close()
            self._read_stream = None

    def before_first(self) -> None:
        if self._iter is None:
            self._start_reader()
        else:
            self._iter.before_first()

    def next_block(self) -> Optional[RowBlock]:
        if self._iter is None:
            self._start_reader()
        return self._iter.next()

    @property
    def num_col(self) -> int:
        return self._max_index + 1

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def close(self) -> None:
        self._stop_reader()


def slab_shard_slices(lo: int, length: int, shard_rows: int):
    """Map an ingest slab occupying global rows ``[lo, lo+length)`` onto
    the equal-block layout (shard ``k`` owns rows
    ``[k·shard_rows, (k+1)·shard_rows)``): returns
    ``[(shard, src_lo, src_hi, dst_lo), ...]`` pieces, in order, whose
    source slices tile the slab exactly.

    A streamed chunk rarely aligns with shard boundaries (the last chunk
    of a ``nrows % (shards · chunk)`` tail may start and end mid-shard),
    so every piece lands at its exact per-shard offset ``dst_lo`` with no
    row dropped or written twice.  In this package one process owns one
    card, so ``HistGBT.make_device_data_iter`` calls it with a single
    shard of every row: the pieces are then the slabs themselves, at
    their global offsets.
    """
    out = []
    pos = lo
    end = lo + length
    while pos < end:
        k = pos // shard_rows
        take = min(end, (k + 1) * shard_rows) - pos
        out.append((k, pos - lo, pos - lo + take, pos - k * shard_rows))
        pos += take
    return out


def iter_dense_slabs(row_iter, num_col: int, batch_rows: int):
    """Yield dense ``(X, y, w)`` float32 slabs of ≤ ``batch_rows`` rows
    from a :class:`RowBlockIter` — the shared staging loop under
    streaming fit/predict (HistGBT.predict_iter).

    Since the ``stream.dataset`` refactor this is a thin adapter over
    the shared :class:`~dmlc_core_tpu_torch.stream.dataset.Dataset`
    abstraction (``Dataset.from_row_iter(...).dense_slabs(...)``) —
    batch and online paths stage slabs through one implementation.

    CSR pages densify straight into one reused staging buffer; pages
    straddling a slab boundary split transparently (RowBlock.slice row
    ranges).  Host memory stays bounded by one slab regardless of the
    dataset.  Pages whose column index reaches ``num_col`` fail loudly —
    a silently truncated feature would corrupt whatever consumes the
    slab.

    The yielded arrays are VIEWS of the reused buffers: consumers must
    copy (or upload with an explicit host copy) before advancing the
    generator.  ``w`` is 1.0 where the page carries no weights.
    """
    from dmlc_core_tpu_torch.stream.dataset import Dataset

    return iter(Dataset.from_row_iter(row_iter)
                .dense_slabs(num_col, batch_rows))


def iter_csr_minibatches(row_iter, batch_rows: int):
    """Yield CSR :class:`RowBlock` minibatches of ≤ ``batch_rows`` rows.

    The sparse twin of :func:`iter_dense_slabs`: pages stream through
    UNDENSIFIED so a 10M+-column CTR dataset never materialises a dense
    slab — consumers (GBLinear.fit_ps, FM.fit_ps) work straight off the
    ``offset``/``index``/``value`` arrays and only ever touch the
    feature ids present in the batch.  Pages larger than ``batch_rows``
    split via zero-copy :meth:`RowBlock.slice`; smaller pages pass
    through whole (ragged tails are fine for SGD — no cross-page
    re-batching, which would force copies).
    """
    CHECK(batch_rows > 0, f"batch_rows must be positive, got {batch_rows}")
    for block in row_iter:
        if block.size <= batch_rows:
            if block.size:
                yield block
            continue
        lo = 0
        while lo < block.size:
            hi = min(block.size, lo + batch_rows)
            yield block.slice(lo, hi)
            lo = hi
