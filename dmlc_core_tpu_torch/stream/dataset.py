"""One streaming ``Dataset`` abstraction for batch AND online paths.

ROADMAP item 5's enabler refactor: before this module, every consumer
wired the data plane by hand — ``data/iter.py`` batch iterators stitched
parsers to slab staging, ``data/device_feed.py`` wrapped ad-hoc host
iterators, and an online path would have needed a third copy of the same
plumbing.  ``Dataset`` is the shared composition layer over the three
existing primitives:

* **source** — a rewindable record/block producer: a
  :class:`~dmlc_core_tpu_torch.data.parsers.Parser` over an
  :class:`~dmlc_core_tpu_torch.io.input_split.InputSplit`
  (:meth:`Dataset.from_uri`), a
  :class:`~dmlc_core_tpu_torch.data.iter.RowBlockIter`
  (:meth:`Dataset.from_row_iter`), an in-memory iterable, or a live
  :class:`~dmlc_core_tpu_torch.stream.tail.RecordIOTailer` chunk stream
  (single-pass, for the online trainer);
* **transform** — :meth:`map` per-item, :meth:`dense_slabs` (CSR row
  blocks → bounded dense ``(X, y, w)`` staging slabs — the logic that
  used to live privately in ``data/iter.iter_dense_slabs``, which is now
  a one-line adapter over this method);
* **pipeline** — :meth:`prefetch` moves production onto a
  :class:`~dmlc_core_tpu_torch.io.threaded_iter.ThreadedIter` producer thread,
  :meth:`device_feed` would hand the whole dataset to the JAX package's
  ``DeviceFeed`` for double-buffered uploads; it is not ported yet and
  refuses.

Batch trainers and the online ``stream.trainer`` consume the same object
— the refactor the train→serve loop needed (doc/streaming.md).

The module also defines the **dense event codec** the streaming examples,
bench and tests share: one event = one RecordIO record holding
``[label, f0 … f{F-1}]`` as little-endian f32 — trivially appendable,
seekable by the tailer, and decodable as one ``np.frombuffer`` per chunk.

This package's own copy of ``dmlc_core_tpu.stream.dataset``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal

__all__ = ["Dataset", "encode_dense_event", "encode_dense_events",
           "decode_dense_events"]


def _dense_slab_iter(blocks: Iterable[Any], num_col: int,
                     batch_rows: int) -> Iterator[Tuple[np.ndarray,
                                                        np.ndarray,
                                                        np.ndarray]]:
    """RowBlock stream → dense ``(X, y, w)`` slabs of ≤ ``batch_rows``
    rows, staged into reused buffers (yielded arrays are VIEWS — copy
    before advancing).  Shared by ``Dataset.dense_slabs`` and the
    ``data/iter.iter_dense_slabs`` adapter."""
    CHECK(batch_rows > 0, f"dense_slabs: batch_rows must be "
                          f"positive, got {batch_rows}")
    stage = np.empty((batch_rows, num_col), np.float32)
    ys = np.empty(batch_rows, np.float32)
    ws = np.empty(batch_rows, np.float32)
    filled = 0
    for b in blocks:
        CHECK(b.nnz == 0 or b.max_index < num_col,
              f"dense_slabs: page has feature index {b.max_index} "
              f"but the consumer expects {num_col} features")
        done = 0
        while done < b.size:
            take = min(b.size - done, batch_rows - filled)
            b.slice(done, done + take).to_dense_into(
                stage[filled:filled + take])
            ys[filled:filled + take] = b.label[done:done + take]
            if b.weight is not None:
                ws[filled:filled + take] = b.weight[done:done + take]
            else:
                ws[filled:filled + take] = 1.0
            filled += take
            done += take
            if filled == batch_rows:
                yield stage, ys, ws
                filled = 0
    if filled:
        yield stage[:filled], ys[:filled], ws[:filled]


class Dataset:
    """A composable, re-iterable stream of items (records, row blocks,
    slabs, batches …).

    Construction wraps a ``make_iter`` thunk; every ``iter(ds)`` call
    invokes it again, so epoch rewind is "make a fresh iterator" — the
    contract :class:`~dmlc_core_tpu_torch.data.device_feed.DeviceFeed` already
    expects.  Single-pass sources (a live tailer) simply raise or return
    empty on the second pass; batch sources (parsers, row iters) rewind
    via their own ``before_first``.
    """

    def __init__(self, make_iter: Callable[[], Iterator[Any]],
                 name: str = "dataset"):
        self._make_iter = make_iter
        #: metrics/threaded-iter label for pipelined stages
        self.name = name

    def __iter__(self) -> Iterator[Any]:
        return self._make_iter()

    # -- sources ---------------------------------------------------------
    @classmethod
    def from_uri(cls, uri: str, part: int = 0, nparts: int = 1,
                 format: Optional[str] = None,
                 nthread: int = 0) -> "Dataset":
        """Parse a (sharded) text URI into CSR
        :class:`~dmlc_core_tpu_torch.data.row_block.RowBlock` items via the
        ``data_parser`` registry (``?format=`` URI key, libsvm default).
        Rewind re-reads through ``Parser.before_first``."""
        from dmlc_core_tpu_torch.data.parsers import Parser

        parser = Parser.create(uri, part, nparts, format, nthread)
        first = [True]

        def make_iter() -> Iterator[Any]:
            if not first[0]:
                parser.before_first()
            first[0] = False
            return iter(parser)

        return cls(make_iter, name=f"uri:{format or 'auto'}")

    @classmethod
    def from_row_iter(cls, row_iter: Any) -> "Dataset":
        """Wrap a :class:`~dmlc_core_tpu_torch.data.iter.RowBlockIter` (its
        ``__iter__`` rewinds via ``before_first``)."""
        return cls(lambda: iter(row_iter), name="row_iter")

    @classmethod
    def from_iterable(cls, src: Iterable[Any] | Callable[[], Iterator[Any]],
                      name: str = "iterable") -> "Dataset":
        """Wrap any iterable (re-iterated per epoch) or iterator factory."""
        make = src if callable(src) else (lambda: iter(src))
        return cls(make, name=name)

    @classmethod
    def from_tailer(cls, tailer: Any, chunk_records: int,
                    timeout: Optional[float] = None,
                    stop: Optional[Callable[[], bool]] = None) -> "Dataset":
        """Single-pass dataset of raw-record chunks pulled from a
        :class:`~dmlc_core_tpu_torch.stream.tail.RecordIOTailer`: each item is
        a list of ≥ 1 records (up to ``chunk_records``, sooner on
        ``timeout``).  Ends when ``stop()`` goes true or a timeout poll
        returns nothing."""

        def make_iter() -> Iterator[List[bytes]]:
            while not (stop is not None and stop()):
                recs = tailer.wait_records(chunk_records, timeout=timeout,
                                           stop=stop)
                if not recs:
                    return
                yield recs

        return cls(make_iter, name=f"tail:{tailer.name}")

    # -- transforms ------------------------------------------------------
    def map(self, fn: Callable[[Any], Any],
            name: Optional[str] = None) -> "Dataset":
        """Lazily apply ``fn`` to every item."""
        src = self._make_iter
        return Dataset(lambda: (fn(x) for x in src()),
                       name=name or self.name)

    def dense_slabs(self, num_col: int, batch_rows: int) -> "Dataset":
        """CSR RowBlock items → dense ``(X, y, w)`` float32 slabs of
        ≤ ``batch_rows`` rows.

        Pages densify straight into one reused staging buffer; pages
        straddling a slab boundary split transparently.  Host memory
        stays bounded by one slab regardless of the dataset; the yielded
        arrays are VIEWS of the reused buffers, so consumers must copy
        (or upload with an explicit host copy) before advancing."""
        src = self._make_iter
        return Dataset(lambda: _dense_slab_iter(src(), num_col, batch_rows),
                       name=self.name)

    # -- pipelining ------------------------------------------------------
    def prefetch(self, capacity: int = 8,
                 name: Optional[str] = None) -> "Dataset":
        """Move production onto a
        :class:`~dmlc_core_tpu_torch.io.threaded_iter.ThreadedIter` producer
        thread (bounded buffer of ``capacity`` items).  The threaded
        stage is created per-iteration and destroyed when the iterator
        is exhausted or closed."""
        from dmlc_core_tpu_torch.io.threaded_iter import ThreadedIter

        src = self._make_iter
        label = name or self.name

        def make_iter() -> Iterator[Any]:
            inner = src()

            def next_fn(_cell):
                return next(inner, None)

            tit: ThreadedIter = ThreadedIter(max_capacity=capacity,
                                             name=label)
            tit.init(next_fn)
            try:
                while (item := tit.next()) is not None:
                    yield item
            finally:
                tit.destroy()

        return Dataset(make_iter, name=label)

    def device_feed(self, sharding: Any, depth: int = 2,
                    host_prefetch: int = 4) -> Any:
        """The JAX package's ``DeviceFeed`` (host parsing on a producer
        thread, uploads ``depth`` batches ahead) — not ported yet."""
        del sharding, depth, host_prefetch
        log_fatal("Dataset.device_feed: DeviceFeed is not ported to this "
                  "package yet")


# ---------------------------------------------------------------------------
# dense event codec (examples / bench / tests / online trainer default)
# ---------------------------------------------------------------------------

def encode_dense_event(features: np.ndarray, label: float) -> bytes:
    """One live event → RecordIO payload bytes: ``[label, f0 … f{F-1}]``
    little-endian float32."""
    row = np.empty(len(features) + 1, dtype="<f4")
    row[0] = label
    row[1:] = features
    return row.tobytes()


def encode_dense_events(X: np.ndarray, y: np.ndarray) -> List[bytes]:
    """Vectorized :func:`encode_dense_event` over a batch."""
    X = np.asarray(X, dtype="<f4")
    y = np.asarray(y, dtype="<f4")
    CHECK(len(X) == len(y), "encode_dense_events: X/y length mismatch")
    packed = np.concatenate([y[:, None], X], axis=1).astype("<f4")
    return [packed[i].tobytes() for i in range(len(packed))]


def decode_dense_events(records: List[bytes],
                        n_features: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_dense_event` over a chunk of records:
    ``(X [n, F] float32, y [n] float32)``."""
    width = (n_features + 1) * 4
    for r in records:
        CHECK(len(r) == width,
              f"decode_dense_events: record of {len(r)} bytes, expected "
              f"{width} (n_features={n_features})")
    flat = np.frombuffer(b"".join(records), dtype="<f4")
    mat = flat.reshape(len(records), n_features + 1)
    return np.ascontiguousarray(mat[:, 1:]), np.ascontiguousarray(mat[:, 0])
