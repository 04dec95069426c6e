"""Host→device infeed pipeline: double-buffered, stall-accounted.

The counterpart of ``dmlc_core_tpu/data/device_feed.py``.  Boundaries #1
(storage read) and #2 (parse) of the reference's threaded prefetch stack
(``src/io/threaded_input_split.h`` + ``include/dmlc/threadediter.h``) stay
on the host in :class:`~dmlc_core_tpu_torch.io.threaded_iter.ThreadedIter`;
this module adds boundary #3, the host→device copy, which decides whether
a trainer is compute- or infeed-bound.

On a CUDA device each batch's arrays are copied into pinned host memory
and go up with ``non_blocking=True`` on a side stream, ``depth`` batches
ahead of the consumer: while step N computes, batch N+1 is crossing PCIe
and batch N+2 is being parsed.  An event recorded after each copy is
waited on by the consumer's stream before the batch is handed out, the
device tensor is marked as used on that stream (``record_stream``), and
each pinned buffer is held until its copy's event has passed, so no
buffer is reused while its copy is in flight.  Pinning that fails raises:
the feed never falls back to pageable copies.  On ``device="cpu"`` the
batches are CPU tensors (no streams, no pinning).  ``stats`` records the
time the consumer blocked on the host pipeline (``stall_s``) against the
wall time: the infeed stall fraction.

The JAX package's ``assemble_row_sharded`` (per-device shards stitched
into one global array) has no counterpart: this package runs one process
per card, so a feed fills one device.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_core_tpu_torch.parallel.mesh import Mesh
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["DeviceFeed", "FeedStats"]


class FeedStats:
    """Infeed counters: batches, bytes, consumer stall time."""

    def __init__(self) -> None:
        self.batches = 0
        self.bytes = 0
        self.stall_s = 0.0
        self.start_t = get_time()

    def stall_fraction(self) -> float:
        wall = max(get_time() - self.start_t, 1e-9)
        return self.stall_s / wall

    def as_dict(self) -> Dict[str, float]:
        return {"batches": self.batches, "bytes": self.bytes,
                "stall_s": round(self.stall_s, 4),
                "stall_fraction": round(self.stall_fraction(), 4)}


def _map(fn: Callable[[Any], Any], batch: Any) -> Any:
    """``fn`` over the array leaves of a batch (tuples, lists and dicts
    nest; anything else is a leaf)."""
    if isinstance(batch, tuple):
        return tuple(_map(fn, b) for b in batch)
    if isinstance(batch, list):
        return [_map(fn, b) for b in batch]
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _leaves(batch: Any) -> list:
    out: list = []
    _map(out.append, batch)
    return out


class DeviceFeed:
    """Stream host batches onto one device, ``depth`` ahead.

    ``host_iter``: an iterable (or a callable returning an iterator, so
    the feed can rewind for multi-epoch training) yielding batches of
    numpy arrays (tuples, lists and dicts of them nest).

    ``device``: the counterpart of the JAX feed's ``sharding`` — a
    ``torch.device`` or its name, ``None`` for ``cuda``, or a
    :class:`~dmlc_core_tpu_torch.parallel.mesh.Mesh` (shorthand for this
    rank's card: one process per card).

    Iterating yields the batches as tensors on ``device`` (on a card,
    ready for the consumer's current stream).  Host-side parsing runs in
    a ``ThreadedIter`` producer thread holding up to ``host_prefetch``
    batches; copies are issued ``depth`` batches ahead.
    """

    def __init__(
        self,
        host_iter: Union[Iterable[Any], Callable[[], Iterator[Any]]],
        device: Union[str, torch.device, Mesh, None] = None,
        depth: int = 2,
        host_prefetch: int = 4,
    ):
        CHECK(depth >= 1, "DeviceFeed: depth must be >= 1")
        self._device = resolve_device(
            None if isinstance(device, Mesh) else device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._make_iter = (host_iter if callable(host_iter)
                           else (lambda: iter(host_iter)))
        self._depth = depth
        self._titer: ThreadedIter = ThreadedIter(max_capacity=host_prefetch,
                                                 name="device_feed")
        self._host_it: Optional[Iterator[Any]] = None
        #: (device batch, copy-done event) in issue order
        self._inflight: deque = deque()
        #: (copy-done event, pinned buffers) held until the event passed
        self._retired: deque = deque()
        self._exhausted = False
        self.stats = FeedStats()

        def next_fn(_reuse):
            # lazy: the producer thread may call this before the first
            # before_first_fn (epoch 0 starts immediately)
            if self._host_it is None:
                self._host_it = self._make_iter()
            try:
                return next(self._host_it)
            except StopIteration:
                return None

        def before_first_fn():
            self._host_it = self._make_iter()

        self._titer.init(next_fn, before_first_fn)

    # -- transfer ------------------------------------------------------
    def _release_done(self) -> None:
        while self._retired and self._retired[0][0].query():
            self._retired.popleft()

    def _put(self, batch: Any):
        if not self._cuda:
            return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)),
                        batch), None
        pinned = []

        def stage(a):
            a = np.ascontiguousarray(a)
            buf = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                              pin_memory=True)
            CHECK(buf.is_pinned(),
                  "DeviceFeed: pinned host memory is unavailable")
            buf.copy_(torch.from_numpy(a))   # torch's copy is multithreaded
            pinned.append(buf)
            return buf

        host = _map(stage, batch)
        with torch.cuda.stream(self._stream):
            dev = _map(lambda t: t.to(self._device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._retired.append((done, pinned))
        return dev, done

    # -- pipeline ------------------------------------------------------
    def _fill(self) -> None:
        while not self._exhausted and len(self._inflight) < self._depth:
            t0 = get_time()
            item = self._titer.next()
            if item is None:
                self._exhausted = True
                return
            # time blocked on the host pipeline = infeed stall
            self.stats.stall_s += get_time() - t0
            self.stats.bytes += sum(np.asarray(a).nbytes
                                    for a in _leaves(item))
            self._inflight.append(self._put(item))
        if self._cuda:
            self._release_done()

    def __iter__(self) -> Iterator[Any]:
        self.before_first()
        return self

    def __next__(self) -> Any:
        self._fill()
        if not self._inflight:
            raise StopIteration
        batch, done = self._inflight.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            _map(lambda t: t.record_stream(consumer), batch)
        self._fill()  # keep the pipe full while the caller computes
        self.stats.batches += 1
        return batch

    def before_first(self) -> None:
        """Rewind for a new epoch (reference ``BeforeFirst`` semantics)."""
        self._titer.before_first()
        self._inflight.clear()
        self._exhausted = False

    def close(self) -> None:
        """Stop the producer, wait for the copies in flight and release
        their pinned buffers."""
        self._titer.destroy()
        if self._cuda:
            self._stream.synchronize()
        self._retired.clear()

    def __enter__(self) -> "DeviceFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
