"""Sharded input splits: partition N bytes of records over K workers.

Reference parity: ``src/io/input_split_base.{h,cc}`` (byte-range math across
multi-file dirs, record-boundary alignment), ``line_split``,
``recordio_split``, ``indexed_recordio_split``, ``single_file_split``,
``threaded_input_split`` (prefetch), ``cached_input_split`` and
``include/dmlc/input_split_shuffle.h`` (SURVEY.md §2b).

Sharding contract (the `unittest_inputsplit` oracle): for any file set and
any ``nparts``, the union of records seen by parts ``0..nparts-1`` equals
the full record set, with no overlap.  This is achieved by a deterministic
alignment function: part ``k`` reads records starting in
``[align(k·total/n), align((k+1)·total/n))`` where ``align`` maps a raw byte
offset to the next record boundary at or after it.  Both endpoints use the
same function, so ranges tile exactly.

``part/nparts`` is the worker's rank and count: each host shards storage
reads for its local devices, and the global batch is assembled by the data
axis, not the I/O layer (SURVEY.md §2e).

This package's own copy of ``dmlc_core_tpu.io.input_split``.  Local files
are read by the native threaded chunk reader (``io/_native_io.py`` over
``cpp/prefetch.cc``) where the native library is present, through Python
file I/O elsewhere and for every other filesystem.
"""

from __future__ import annotations

import random as _random
from collections import deque as _deque
from typing import Iterator, List, Optional, Tuple

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_GE, CHECK_LT, log_fatal
from dmlc_core_tpu_torch.base.registry import Registry
from dmlc_core_tpu_torch.io.filesystem import FileInfo, FileSystem, URI
from dmlc_core_tpu_torch.io.recordio import (
    RECORDIO_MAGIC_BYTES,
    RecordIOChunkReader,
    decode_flag,
    decode_length,
)
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.io.threaded_iter import ThreadedIter

__all__ = ["InputSplit", "InputSplitBase", "LineSplit", "RecordIOSplit",
           "IndexedRecordIOSplit", "SingleFileSplit", "ThreadedInputSplit",
           "CachedInputSplit", "InputSplitShuffle"]

SPLIT_REGISTRY: Registry = Registry.get("input_split")

_DEFAULT_CHUNK = 1 << 20  # 1 MiB storage-read granularity


class InputSplit:
    """Abstract record split.  Reference: ``dmlc::InputSplit`` (io.h).

    ``next_record() -> bytes | None``; ``next_chunk() -> bytes | None``
    (a blob of whole records); ``before_first()``;
    ``reset_partition(part, nparts)``; ``hint_chunk_size(nbytes)``.
    """

    def next_record(self) -> Optional[bytes]:
        raise NotImplementedError

    def next_chunk(self) -> Optional[bytes]:
        raise NotImplementedError

    def next_batch(self, n_records: int) -> List[bytes]:
        """Up to ``n_records`` records (empty list at end)."""
        out: List[bytes] = []
        while len(out) < n_records:
            rec = self.next_record()
            if rec is None:
                break
            out.append(rec)
        return out

    def before_first(self) -> None:
        raise NotImplementedError

    def reset_partition(self, part: int, nparts: int) -> None:
        raise NotImplementedError

    def hint_chunk_size(self, nbytes: int) -> None:
        pass

    def close(self) -> None:
        pass

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    def __enter__(self) -> "InputSplit":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- factory ---------------------------------------------------------
    @staticmethod
    def create(
        uri: str,
        part: int = 0,
        nparts: int = 1,
        type: str = "text",
        *,
        threaded: bool = True,
        shuffle_buffer: int = 0,
        seed: int = 0,
        cache_file: Optional[str] = None,
        batch_size: int = 256,
    ) -> "InputSplit":
        """Build a split by type: ``text``/``line``, ``recordio``,
        ``indexed_recordio``.  Reference: ``src/io.cc :: InputSplit::Create``
        — wraps the base split in threaded prefetch, optional shuffle and
        read-through cache decorators.
        """
        CHECK_GE(part, 0)
        CHECK_LT(part, nparts, f"part {part} out of range for nparts {nparts}")
        if uri == "stdin":
            CHECK(nparts == 1, "stdin input cannot be partitioned")
            return SingleFileSplit(uri)
        entry = SPLIT_REGISTRY.find(type)
        if entry is None:
            log_fatal(
                f"InputSplit.create: unknown type {type!r}; "
                f"known: {SPLIT_REGISTRY.list_all_names()}"
            )
        split: InputSplit = entry(uri, part, nparts, batch_size=batch_size)
        if cache_file is not None:
            split = CachedInputSplit(split, cache_file)
        elif threaded and isinstance(split, InputSplitBase):
            split = ThreadedInputSplit(split)
        if shuffle_buffer > 0:
            split = InputSplitShuffle(split, shuffle_buffer, seed)
        return split


def _split_multi_uri(uri: str) -> List[str]:
    """Split a ';'-separated path list (reference ``src/io.cc`` behavior)
    without mangling URLs whose query strings contain ';' (legacy
    ``?a=1;b=2`` parameter separators): when the first path carries a
    protocol, a fragment WITHOUT one cannot be a new path — it is rejoined
    to its predecessor."""
    frags = [s for s in uri.split(";") if s]
    if not frags or "://" not in frags[0]:
        return frags           # local paths: plain reference behavior
    paths: List[str] = [frags[0]]
    for frag in frags[1:]:
        if "://" in frag:
            paths.append(frag)
        else:
            paths[-1] += ";" + frag
    return paths


class InputSplitBase(InputSplit):
    """Byte-range sharding over a (multi-file) URI.

    Subclasses define record-boundary semantics via :meth:`_align` (map a
    raw in-file offset to the next record start) and :meth:`_extract`
    (split a carry buffer into complete records + remainder).  Records never
    span files (each file is independent, like the reference).
    """

    def __init__(self, uri: str, part: int, nparts: int, **_kw):
        # ';'-separated multi-path URIs (reference: src/io.cc splits the
        # path list before ListDirectory) — also the only way to shard
        # over list-incapable backends like plain HTTP
        paths = _split_multi_uri(uri)
        CHECK(len(paths) > 0, f"InputSplit: empty uri {uri!r}")
        self._uri = URI(paths[0])
        self._fs = FileSystem.get_instance(self._uri)
        if self._fs is None:
            log_fatal(f"InputSplit: no filesystem for {uri!r}")
        self._files: List[FileInfo] = []
        for path in paths:
            u = URI(path)
            CHECK(u.protocol == self._uri.protocol,
                  "InputSplit: all ';' paths must share one protocol")
            self._files += self._fs.list_directory_ex(u)
        self._files = [f for f in self._files if f.size > 0]
        self._sizes = [f.size for f in self._files]
        self._cum = [0]
        for s in self._sizes:
            self._cum.append(self._cum[-1] + s)
        self._total = self._cum[-1]
        self._chunk_size = _DEFAULT_CHUNK
        self._stream: Optional[SeekStream] = None
        self._stream_fidx = -1
        self.reset_partition(part, nparts)

    # -- partition math --------------------------------------------------
    def reset_partition(self, part: int, nparts: int) -> None:
        CHECK_GE(part, 0)
        CHECK_LT(part, nparts)
        self._part, self._nparts = part, nparts
        raw_begin = self._total * part // nparts
        raw_end = self._total * (part + 1) // nparts
        self._begin = self._align_global(raw_begin)
        self._end = self._align_global(raw_end)
        self.before_first()

    def before_first(self) -> None:
        self._pos = self._begin
        self._carry = b""
        self._pending: _deque = _deque()
        self._stop_native_reader()

    # -- native prefetch fast path ---------------------------------------
    def _stop_native_reader(self) -> None:
        old = getattr(self, "_native", None)
        if old is not None:
            old.close()
        self._native = None
        self._native_started = False

    def _ensure_native_reader(self) -> None:
        """Lazily start the native threaded chunk reader (cpp/prefetch.cc)
        on the first real read — the C++ counterpart of the reference's
        ``ThreadedInputSplit`` storage-read thread.  Lazy start (like
        ``ThreadedInputSplit``) so ``hint_chunk_size`` lands before the
        producer begins and unconsumed splits never spawn a thread.
        Produces the identical chunk sequence to the Python ``_read_at``
        loop in :meth:`next_chunk`."""
        if self._native_started:
            return
        self._native_started = True
        self._native_fidx: List[int] = []
        from dmlc_core_tpu_torch.io import _native_io
        from dmlc_core_tpu_torch.io.filesystem import LocalFileSystem

        if (not isinstance(self._fs, LocalFileSystem)
                or not _native_io.native_io_available()
                or self._pos != self._begin  # mid-range: stay on Python path
                or self._begin >= self._end):
            return
        segments = []
        for fidx in range(len(self._files)):
            lo = max(self._begin, self._cum[fidx])
            hi = min(self._end, self._cum[fidx + 1])
            if lo < hi:
                segments.append((URI(self._files[fidx].path).name,
                                 lo - self._cum[fidx], hi - self._cum[fidx]))
                self._native_fidx.append(fidx)
        if segments:
            self._native = _native_io.NativeChunkReader(segments, self._chunk_size)

    def hint_chunk_size(self, nbytes: int) -> None:
        self._chunk_size = max(nbytes, 4096)

    def _find_file(self, offset: int) -> int:
        """Index of the file containing global ``offset``."""
        lo, hi = 0, len(self._files) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if offset >= self._cum[mid + 1]:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _align_global(self, offset: int) -> int:
        """Next record boundary at or after global ``offset``."""
        if offset >= self._total:
            return self._total
        fidx = self._find_file(offset)
        local = offset - self._cum[fidx]
        if local == 0:
            return offset  # file start is always a record boundary
        aligned_local = self._align(fidx, local)
        if aligned_local is None:  # no boundary before EOF → next file
            return self._cum[fidx + 1]
        return self._cum[fidx] + aligned_local

    # -- subclass hooks --------------------------------------------------
    def _align(self, fidx: int, local_offset: int) -> Optional[int]:
        """Next in-file record-start offset ≥ ``local_offset`` (None = none)."""
        raise NotImplementedError

    def _extract(self, buf: bytes, at_eof: bool) -> Tuple[List[bytes], bytes]:
        """Split ``buf`` into complete records + unconsumed remainder."""
        raise NotImplementedError

    # -- shared read machinery -------------------------------------------
    def _open(self, fidx: int) -> SeekStream:
        if self._stream_fidx != fidx:
            if self._stream is not None:
                self._stream.close()
            self._stream = self._fs.open_for_read(URI(self._files[fidx].path))
            self._stream_fidx = fidx
        return self._stream  # type: ignore[return-value]

    def _read_at(self, offset: int, nbytes: int) -> bytes:
        """Read up to ``nbytes`` from global ``offset`` (single file)."""
        fidx = self._find_file(offset)
        local = offset - self._cum[fidx]
        stream = self._open(fidx)
        stream.seek(local)
        return stream.read(min(nbytes, self._sizes[fidx] - local))

    def next_chunk(self) -> Optional[bytes]:
        """Next blob of complete records (None at end of this part's range).

        Invariant: ``_begin`` and ``_end`` are both record boundaries (same
        ``_align_global``), so ranges tile exactly and a read stopping at
        ``_end`` always lands on a record end — a leftover there means
        corrupt input.  The carry only bridges chunk reads *within* a file
        (file ends are record ends; ``_extract(…, at_eof=True)`` flushes).
        """
        while True:
            if self._pos >= self._end:
                if self._carry:
                    log_fatal("InputSplit: partial record at aligned range end "
                              "(corrupt input?)")
                return None
            self._ensure_native_reader()
            if self._native is not None:
                item = self._native.next()
                if item is None:
                    log_fatal("InputSplit: short read inside assigned range")
                fidx = self._native_fidx[item[0]]
                data = item[1]
            else:
                fidx = self._find_file(self._pos)
                want = min(self._chunk_size, self._end - self._pos)
                data = self._read_at(self._pos, want)
                if not data:
                    log_fatal("InputSplit: short read inside assigned range")
            self._pos += len(data)
            if self._carry:
                data = self._carry + data
                self._carry = b""
            at_file_end = self._pos >= self._cum[fidx + 1]
            recs, rem = self._extract(data, at_file_end)
            if rem:
                if at_file_end:
                    log_fatal(
                        f"InputSplit: incomplete record at end of file "
                        f"{self._files[fidx].path!r} (is it the right format?)"
                    )
                self._carry = rem
            if recs:
                return self._join(recs)

    @staticmethod
    def _join(recs: List[bytes]) -> bytes:
        raise NotImplementedError

    def next_record(self) -> Optional[bytes]:
        while not self._pending:
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._pending = _deque(self._records_from_chunk(chunk))
        return self._pending.popleft()

    def _records_from_chunk(self, chunk: bytes) -> List[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        self._stop_native_reader()
        if self._stream is not None:
            self._stream.close()
            self._stream = None
            self._stream_fidx = -1


@SPLIT_REGISTRY.register("text")
@SPLIT_REGISTRY.register("line")
class LineSplit(InputSplitBase):
    """Newline-delimited records.  Reference: ``src/io/line_split.cc``.

    A record is a line without its ``\\n`` terminator (a trailing ``\\r`` is
    also stripped); the last line of a file needs no terminator.
    """

    def _align(self, fidx: int, local_offset: int) -> Optional[int]:
        # a record starts after the previous '\n': scan from local_offset-1
        stream = self._open(fidx)
        stream.seek(local_offset - 1)
        scan_base = local_offset - 1
        while True:
            buf = stream.read(self._chunk_size)
            if not buf:
                return None
            nl = buf.find(b"\n")
            if nl >= 0:
                return scan_base + nl + 1
            scan_base += len(buf)

    def _extract(self, buf: bytes, at_eof: bool) -> Tuple[List[bytes], bytes]:
        if at_eof:
            return ([buf] if buf else []), b""
        last_nl = buf.rfind(b"\n")
        if last_nl < 0:
            return [], buf
        return [buf[: last_nl + 1]], buf[last_nl + 1 :]

    @staticmethod
    def _join(recs: List[bytes]) -> bytes:
        return b"".join(recs)

    def _records_from_chunk(self, chunk: bytes) -> List[bytes]:
        lines = chunk.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        return [ln[:-1] if ln.endswith(b"\r") else ln for ln in lines]


@SPLIT_REGISTRY.register("recordio")
class RecordIOSplit(InputSplitBase):
    """RecordIO records.  Reference: ``src/io/recordio_split.cc`` — align by
    scanning 4-byte-aligned offsets for the magic with a record-start cflag
    (0 or 1); escaped payloads guarantee no false positives."""

    def _align(self, fidx: int, local_offset: int) -> Optional[int]:
        stream = self._open(fidx)
        scan_from = (local_offset + 3) >> 2 << 2  # headers are 4-byte aligned
        stream.seek(scan_from)
        buf = b""
        buf_base = scan_from  # in-file offset of buf[0]
        while True:
            more = stream.read(self._chunk_size)
            if not more:
                return None
            buf += more
            pos = buf.find(RECORDIO_MAGIC_BYTES)
            while pos >= 0:
                gpos = buf_base + pos
                if gpos % 4 == 0 and pos + 8 <= len(buf):
                    lrec = int.from_bytes(buf[pos + 4 : pos + 8], "little")
                    if decode_flag(lrec) in (0, 1):
                        return gpos
                pos = buf.find(RECORDIO_MAGIC_BYTES, pos + 1)
            # keep a 7-byte tail so a header straddling reads is still found
            keep = min(len(buf), 7)
            buf_base += len(buf) - keep
            buf = buf[-keep:]

    def _extract(self, buf: bytes, at_eof: bool) -> Tuple[List[bytes], bytes]:
        """Consume complete records (all continuation parts present)."""
        consumed = 0
        pos = 0
        n = len(buf)
        while pos + 8 <= n:
            lrec = int.from_bytes(buf[pos + 4 : pos + 8], "little")
            clen = decode_length(lrec)
            cflag = decode_flag(lrec)
            part_end = pos + 8 + (((clen + 3) >> 2) << 2)
            if part_end > n:
                break
            pos = part_end
            if cflag in (0, 3):  # record complete
                consumed = pos
        return ([buf[:consumed]] if consumed else []), buf[consumed:]

    @staticmethod
    def _join(recs: List[bytes]) -> bytes:
        return b"".join(recs)

    def _records_from_chunk(self, chunk: bytes) -> List[bytes]:
        from dmlc_core_tpu_torch.io.recordio import decode_chunk

        return decode_chunk(chunk)


class SingleFileSplit(InputSplit):
    """stdin or one file as line records, no partitioning.

    Reference: ``src/io/single_file_split.h``.
    """

    def __init__(self, uri: str, part: int = 0, nparts: int = 1, **_kw):
        self._uri = uri
        self._records: Optional[List[bytes]] = None
        self._idx = 0

    def _load(self) -> None:
        if self._records is not None:
            return
        stream = Stream.create(self._uri, "r")
        data = stream.read_all()
        stream.close()
        lines = data.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        self._records = [ln[:-1] if ln.endswith(b"\r") else ln for ln in lines]

    def next_record(self) -> Optional[bytes]:
        self._load()
        if self._idx >= len(self._records):  # type: ignore[arg-type]
            return None
        rec = self._records[self._idx]  # type: ignore[index]
        self._idx += 1
        return rec

    def next_chunk(self) -> Optional[bytes]:
        self._load()
        if self._idx >= len(self._records):  # type: ignore[arg-type]
            return None
        chunk = b"\n".join(self._records[self._idx :]) + b"\n"  # type: ignore[index]
        self._idx = len(self._records)  # type: ignore[arg-type]
        return chunk

    def before_first(self) -> None:
        self._idx = 0

    def reset_partition(self, part: int, nparts: int) -> None:
        CHECK(nparts == 1, "SingleFileSplit cannot be partitioned")
        self.before_first()


@SPLIT_REGISTRY.register("indexed_recordio")
class IndexedRecordIOSplit(InputSplit):
    """Random-access RecordIO via a ``.idx`` sidecar of ``key\\toffset`` lines.

    Reference: ``src/io/indexed_recordio_split.cc`` — partitions *record
    indices* (not bytes) over workers; supports seeded shuffling per epoch
    and batched random-access reads.  The index URI defaults to
    ``<uri>.idx``.
    """

    def __init__(self, uri: str, part: int, nparts: int, *, index_uri: Optional[str] = None,
                 batch_size: int = 256, shuffle: bool = False, seed: int = 0, **_kw):
        base_uri = uri
        self._data_uri = URI(base_uri)
        self._fs = FileSystem.get_instance(self._data_uri)
        if self._fs is None:
            log_fatal(f"IndexedRecordIOSplit: no filesystem for {uri!r}")
        idx_uri = index_uri or (base_uri + ".idx")
        with Stream.create(idx_uri, "r") as s:
            text = s.read_all().decode("utf-8")
        self._index: List[Tuple[str, int]] = []
        for line in text.splitlines():
            if not line.strip():
                continue
            key, _, off = line.partition("\t")
            self._index.append((key, int(off)))
        info = self._fs.get_path_info(self._data_uri)
        self._file_size = info.size
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._stream: Optional[SeekStream] = None
        self.reset_partition(part, nparts)

    def reset_partition(self, part: int, nparts: int) -> None:
        n = len(self._index)
        begin = n * part // nparts
        end = n * (part + 1) // nparts
        self._my_indices = list(range(begin, end))
        self.before_first()

    def before_first(self) -> None:
        self._order = list(self._my_indices)
        if self._shuffle:
            _random.Random(self._seed + self._epoch).shuffle(self._order)
            self._epoch += 1
        self._cursor = 0

    def _read_record_at(self, i: int) -> bytes:
        if self._stream is None:
            self._stream = self._fs.open_for_read(self._data_uri)
        offset = self._index[i][1]
        end = self._index[i + 1][1] if i + 1 < len(self._index) else self._file_size
        self._stream.seek(offset)
        blob = self._stream.read_exact(end - offset)
        rec = RecordIOChunkReader(blob).next_record()
        if rec is None:
            log_fatal(f"IndexedRecordIOSplit: no record at offset {offset}")
        return rec

    def next_record(self) -> Optional[bytes]:
        if self._cursor >= len(self._order):
            return None
        rec = self._read_record_at(self._order[self._cursor])
        self._cursor += 1
        return rec

    def next_chunk(self) -> Optional[bytes]:
        """A batch of raw recordio bytes (batch_size records)."""
        recs = self.next_batch(self._batch_size)
        if not recs:
            return None
        from dmlc_core_tpu_torch.io.recordio import encode_records

        return encode_records(recs)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    @property
    def keys(self) -> List[str]:
        return [k for k, _ in self._index]


class ThreadedInputSplit(InputSplit):
    """Prefetch decorator: a producer thread pulls chunks ahead of the
    consumer.  Reference: ``src/io/threaded_input_split.h`` — thread
    boundary #1 of the data pipeline (storage read overlaps parse)."""

    def __init__(self, base: InputSplitBase, max_capacity: int = 8):
        self._base = base
        self._max_capacity = max_capacity
        # lazy start: prefetching before the consumer's first read would
        # lock in chunk size before hint_chunk_size() can land
        self._iter: Optional[ThreadedIter] = None
        self._closed = False
        self._pending: _deque = _deque()

    def _ensure_started(self) -> Optional[ThreadedIter]:
        if self._closed:
            return None
        if self._iter is None:
            self._iter = ThreadedIter(max_capacity=self._max_capacity)
            self._iter.init(lambda _cell: self._base.next_chunk(), self._base.before_first)
        return self._iter

    def _stop(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None

    def next_chunk(self) -> Optional[bytes]:
        it = self._ensure_started()
        return None if it is None else it.next()

    def next_record(self) -> Optional[bytes]:
        while not self._pending:
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._pending = _deque(self._base._records_from_chunk(chunk))
        return self._pending.popleft()

    def before_first(self) -> None:
        self._pending = _deque()
        if self._iter is not None:
            self._iter.before_first()

    def reset_partition(self, part: int, nparts: int) -> None:
        self._stop()
        self._base.reset_partition(part, nparts)
        self._pending = _deque()

    def hint_chunk_size(self, nbytes: int) -> None:
        self._base.hint_chunk_size(nbytes)

    def close(self) -> None:
        self._closed = True
        self._stop()
        self._base.close()


class CachedInputSplit(InputSplit):
    """Read-through cache: pass 1 tees chunks to a local cache file, later
    passes replay the cache (for remote/slow filesystems).

    Reference: ``src/io/cached_input_split.h``.  Cache format: length-
    prefixed chunks via the binary serializer.
    """

    def __init__(self, base: InputSplitBase, cache_uri: str):
        from dmlc_core_tpu_torch.io import serializer as ser

        CHECK(
            isinstance(base, InputSplitBase),
            "CachedInputSplit needs an InputSplitBase (for record framing)",
        )
        self._base: Optional[InputSplitBase] = base
        # record extraction must follow the base format (recordio vs line),
        # and must outlive the base (which is dropped after pass 1)
        self._records_from_chunk = base._records_from_chunk
        self._cache_uri = cache_uri
        self._ser = ser
        self._write_stream: Optional[Stream] = Stream.create(cache_uri, "w")
        self._read_stream: Optional[Stream] = None
        self._pending: _deque = _deque()

    def next_chunk(self) -> Optional[bytes]:
        if self._base is not None:  # pass 1: read source, tee to cache
            chunk = self._base.next_chunk()
            if chunk is None:
                self._finish_write()
                return None
            self._ser.write_bytes(self._write_stream, chunk)
            return chunk
        if self._read_stream is None:
            self._read_stream = Stream.create(self._cache_uri, "r")
        head = self._read_stream.read(8)
        if len(head) == 0:
            return None  # clean EOF
        if len(head) < 8:
            # partial length prefix = interrupted pass-1 write; read_exact
            # fatals rather than silently truncating the epoch
            head += self._read_stream.read_exact(8 - len(head))
        n = int.from_bytes(head, "little")
        return self._read_stream.read_exact(n)

    def _finish_write(self) -> None:
        if self._write_stream is not None:
            self._write_stream.close()
            self._write_stream = None
        if self._base is not None:
            self._base.close()
            self._base = None

    def next_record(self) -> Optional[bytes]:
        while not self._pending:
            chunk = self.next_chunk()
            if chunk is None:
                return None
            self._pending = _deque(self._records_from_chunk(chunk))
        return self._pending.popleft()

    def before_first(self) -> None:
        if self._base is not None:
            # first pass incomplete — restart source and truncate cache
            self._base.before_first()
            if self._write_stream is not None:
                self._write_stream.close()
            self._write_stream = Stream.create(self._cache_uri, "w")
        else:
            if self._read_stream is not None:
                self._read_stream.close()
            self._read_stream = None
        self._pending = _deque()

    def reset_partition(self, part: int, nparts: int) -> None:
        log_fatal("CachedInputSplit: cannot repartition a cached split")

    def close(self) -> None:
        self._finish_write()
        if self._read_stream is not None:
            self._read_stream.close()
            self._read_stream = None


class InputSplitShuffle(InputSplit):
    """Buffered record shuffling decorator.

    Reference: ``include/dmlc/input_split_shuffle.h`` — fills a buffer of
    ``shuffle_buffer`` records, yields them in seeded-random order; the seed
    advances per epoch so epochs differ deterministically.
    """

    def __init__(self, base: InputSplit, shuffle_buffer: int, seed: int = 0):
        CHECK(shuffle_buffer > 0, "shuffle_buffer must be positive")
        self._base = base
        self._cap = shuffle_buffer
        self._seed = seed
        self._epoch = 0
        self._rng = _random.Random(self._mix())
        self._buf: List[bytes] = []
        self._out: List[bytes] = []

    def _mix(self) -> int:
        return hash((self._seed, self._epoch)) & 0x7FFFFFFF

    def next_record(self) -> Optional[bytes]:
        if self._out:
            return self._out.pop()
        while len(self._buf) < self._cap:
            rec = self._base.next_record()
            if rec is None:
                break
            self._buf.append(rec)
        if not self._buf:
            return None
        self._rng.shuffle(self._buf)
        self._out = self._buf
        self._buf = []
        return self._out.pop()

    def next_chunk(self) -> Optional[bytes]:
        # chunks pass through unshuffled (framing must be preserved; the
        # shuffle granularity of this decorator is the record, matching the
        # reference, whose NextChunk is likewise a pass-through)
        return self._base.next_chunk()

    def before_first(self) -> None:
        self._base.before_first()
        self._epoch += 1
        self._rng = _random.Random(self._mix())
        self._buf, self._out = [], []

    def reset_partition(self, part: int, nparts: int) -> None:
        self._base.reset_partition(part, nparts)
        self._epoch = 0
        self._rng = _random.Random(self._mix())
        self._buf, self._out = [], []

    def hint_chunk_size(self, nbytes: int) -> None:
        self._base.hint_chunk_size(nbytes)

    def close(self) -> None:
        self._base.close()
