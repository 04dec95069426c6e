"""RecordIO: splittable binary record format.

Reference parity: ``include/dmlc/recordio.h + src/recordio.cc ::
RecordIOWriter/Reader/ChunkReader, kMagic = 0xced7230a`` (SURVEY.md §2a).

Wire format (must match the reference byte-for-byte — it's the ``.rec``
format MXNet image pipelines shard over):

* every part: ``[magic:u32le][lrec:u32le][payload][0-pad to 4 bytes]``
* ``lrec`` = (cflag << 29) | length, cflag ∈ {0 whole, 1 start, 2 middle,
  3 end}, length < 2^29
* records containing the magic u32 at a 4-byte-aligned offset are split
  there: the embedded magic is *consumed* by the writer and re-inserted by
  the reader when joining parts — so scanning for ``magic`` at aligned
  offsets always finds true record starts, which is what makes byte-range
  sharding (``RecordIOSplit``) safe.

Unbounded record size via cflag continuation means arbitrarily long
sequence records stream through fixed-size chunks — the property the TPU
data plane inherits for long-context workloads (SURVEY.md §5).

This package's own copy of ``dmlc_core_tpu.io.recordio`` (the same bytes).
:func:`encode_records` and :func:`decode_chunk` take the native codec
(``io/_native_io.py`` over ``cpp/recordio.cc``) where the native library
is present, the Python writer and chunk reader elsewhere.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Optional

from dmlc_core_tpu_torch.base.logging import (CHECK, CHECK_EQ, CHECK_LT, LOG,
                                        log_fatal)
from dmlc_core_tpu_torch.io.stream import Stream

__all__ = [
    "RECORDIO_MAGIC",
    "RECORDIO_MAGIC_BYTES",
    "RecordIOWriter",
    "RecordIOReader",
    "RecordIOChunkReader",
    "encode_lrec",
    "decode_flag",
    "decode_length",
    "decode_chunk",
    "encode_records",
]

RECORDIO_MAGIC = 0xCED7230A
RECORDIO_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)
_U32 = struct.Struct("<I")
_MAX_LEN = (1 << 29) - 1


def encode_lrec(cflag: int, length: int) -> int:
    """(3-bit cflag | 29-bit length)."""
    return (cflag << 29) | length


def decode_flag(lrec: int) -> int:
    """Continuation flag (upper 3 bits) of a RecordIO length word
    (reference recordio.h ``DecodeFlag``)."""
    return (lrec >> 29) & 7


def decode_length(lrec: int) -> int:
    """Payload byte length (lower 29 bits) of a RecordIO length word
    (reference recordio.h ``DecodeLength``)."""
    return lrec & _MAX_LEN


class RecordIOWriter:
    """Write records with magic-escaping.  Reference: ``RecordIOWriter``.

    Accepts an open :class:`Stream` or a path/URI (opened for write via
    ``Stream.create`` and owned/closed by the writer).
    """

    def __init__(self, stream):
        if isinstance(stream, (str, os.PathLike)):
            stream = Stream.create(str(stream), "w")
        self._stream = stream
        self.except_counter = 0  # number of embedded magics escaped

    def close(self) -> None:
        self._stream.close()

    def __enter__(self) -> "RecordIOWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def write_record(self, data: bytes) -> None:
        CHECK_LT(len(data), 1 << 29, "RecordIO: record too large")
        size = len(data)
        lower_align = (size >> 2) << 2
        upper_align = ((size + 3) >> 2) << 2
        dptr = 0
        # scan 4-byte-aligned offsets for embedded magic; split there
        pos = data.find(RECORDIO_MAGIC_BYTES)
        while 0 <= pos < lower_align:
            if pos % 4 == 0:
                cflag = 1 if dptr == 0 else 2
                self._write_part(cflag, data[dptr:pos])
                dptr = pos + 4  # the magic itself is consumed
                self.except_counter += 1
                pos = data.find(RECORDIO_MAGIC_BYTES, dptr)
            else:
                pos = data.find(RECORDIO_MAGIC_BYTES, pos + 1)
        cflag = 3 if dptr != 0 else 0
        self._write_part(cflag, data[dptr:])
        if upper_align != size:
            self._stream.write(b"\x00" * (upper_align - size))

    def _write_part(self, cflag: int, payload: bytes) -> None:
        self._stream.write(RECORDIO_MAGIC_BYTES)
        self._stream.write(_U32.pack(encode_lrec(cflag, len(payload))))
        if payload:
            self._stream.write(payload)
            if cflag in (1, 2):
                # interior parts end exactly where an aligned magic was
                # consumed, so they are already 4-byte aligned
                pass


class RecordIOReader:
    """Read records, reassembling escaped parts.  Reference: ``RecordIOReader``.

    Accepts an open :class:`Stream` or a path/URI (opened for read via
    ``Stream.create`` and owned/closed by the reader).

    Damage tolerance (beyond the reference, which asserts): a **torn
    final record** — the partial header/payload a writer killed
    mid-append leaves at EOF, the normal state of a live append-only
    shard — is treated as end of stream (the partial tail is discarded
    and ``torn_tail`` is set) instead of raising.  Mid-stream corruption
    **resyncs on the magic marker**: the reader scans forward for the
    next 4-byte-aligned magic with a record-start cflag (the writer's
    magic-escaping guarantees aligned magic is a true boundary), skips
    the garbage, warns, and counts it on ``resyncs``.  Clean input
    decodes byte-identically to the strict reader.
    """

    def __init__(self, stream):
        if isinstance(stream, (str, os.PathLike)):
            stream = Stream.create(str(stream), "r")
        self._stream = stream
        self._buf = b""
        self._base = 0      # stream offset of _buf[0] (alignment anchor)
        self._eof = False
        #: count of magic-marker resyncs past corrupt byte ranges
        self.resyncs = 0
        #: True once a partial record was discarded at EOF
        self.torn_tail = False

    def close(self) -> None:
        self._stream.close()

    def __enter__(self) -> "RecordIOReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- buffered scanning ----------------------------------------------
    def _fill(self, n: int) -> None:
        """Grow the buffer to ≥ ``n`` bytes (or EOF)."""
        while len(self._buf) < n and not self._eof:
            more = self._stream.read(max(n - len(self._buf), 1 << 16))
            if not more:
                self._eof = True
            else:
                self._buf += more

    def _consume(self, n: int) -> None:
        self._buf = self._buf[n:]
        self._base += n

    def _mark_torn(self, why: str) -> None:
        if not self.torn_tail:
            self.torn_tail = True
            LOG("WARNING", "RecordIO: torn record at end of stream "
                "(offset %d): %s — treating as EOF", self._base, why)

    def _resync(self) -> bool:
        """Called with a bad magic at ``_buf[0]``: skip forward to the
        next verifiable aligned record start.  Returns False when the
        rest of the stream holds none (all remaining bytes consumed)."""
        skipped = 0
        while True:
            idx = self._buf.find(RECORDIO_MAGIC_BYTES, 1)
            while idx >= 0:
                if (self._base + idx) % 4 == 0:
                    self._fill(idx + 8)
                    if len(self._buf) < idx + 8:
                        break       # candidate torn at EOF — give up below
                    lrec = _U32.unpack_from(self._buf, idx + 4)[0]
                    if decode_flag(lrec) in (0, 1):
                        self._consume(idx)
                        skipped += idx
                        self.resyncs += 1
                        LOG("WARNING", "RecordIO: bad magic — resynced "
                            "past %d bytes to offset %d", skipped,
                            self._base)
                        return True
                idx = self._buf.find(RECORDIO_MAGIC_BYTES, idx + 1)
            if self._eof:
                skipped += len(self._buf)
                self._consume(len(self._buf))
                self.resyncs += 1
                LOG("WARNING", "RecordIO: bad magic — %d trailing bytes "
                    "hold no further record, treating as EOF", skipped)
                return False
            # keep a 7-byte tail so a header straddling reads is found
            keep = min(len(self._buf), 7)
            drop = len(self._buf) - keep
            self._consume(drop)
            skipped += drop
            self._fill(keep + (1 << 16))

    def next_record(self) -> Optional[bytes]:
        """Return the next record, or None at EOF."""
        parts: list[bytes] = []
        while True:
            self._fill(8)
            if len(self._buf) < 8:
                if self._buf:
                    self._mark_torn("truncated header")
                    self._consume(len(self._buf))
                elif parts:
                    self._mark_torn("EOF inside a multi-part record")
                return None
            magic = _U32.unpack_from(self._buf, 0)[0]
            if magic != RECORDIO_MAGIC:
                parts = []
                if not self._resync():
                    return None
                continue
            lrec = _U32.unpack_from(self._buf, 4)[0]
            cflag, clen = decode_flag(lrec), decode_length(lrec)
            payload_end = 8 + clen
            part_end = 8 + (((clen + 3) >> 2) << 2)
            self._fill(part_end)
            if len(self._buf) < payload_end:
                self._mark_torn("truncated payload")
                self._consume(len(self._buf))
                return None
            if cflag in (0, 1) and parts:
                # a fresh start mid-record: the previous record lost its
                # tail to corruption — drop it and carry on from here
                parts = []
                self.resyncs += 1
                LOG("WARNING", "RecordIO: record start inside a "
                    "multi-part record at offset %d — dropping the "
                    "orphaned prefix", self._base)
            if cflag in (2, 3):
                parts.append(RECORDIO_MAGIC_BYTES)  # re-insert consumed magic
            if clen:
                parts.append(self._buf[8:payload_end])
            self._consume(min(part_end, len(self._buf)))
            if cflag in (0, 3):
                return b"".join(parts)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def decode_chunk(chunk: bytes) -> list:
    """All records in a chunk of complete parts — the infeed hot path.

    Dispatches to the native decoder (``cpp/recordio.cc``) when built,
    falling back to :class:`RecordIOChunkReader`.
    """
    from dmlc_core_tpu_torch.io import _native_io

    if _native_io.native_io_available():
        try:
            return _native_io.recordio_decode(chunk)
        except ValueError as e:
            log_fatal(str(e))
    return list(RecordIOChunkReader(chunk))


def encode_records(records: list) -> bytes:
    """Frame a batch of records into one RecordIO byte stream.

    Native fast path when built; byte-identical to ``RecordIOWriter``.
    """
    from dmlc_core_tpu_torch.io import _native_io

    if _native_io.native_io_available():
        return _native_io.recordio_encode(records)
    from dmlc_core_tpu_torch.io.memory_io import MemoryStringStream

    buf = MemoryStringStream()
    w = RecordIOWriter(buf)
    for r in records:
        w.write_record(r)
    return bytes(buf.data)


class RecordIOChunkReader:
    """Extract records from an in-memory chunk (zero stream round-trips).

    Reference parity: ``RecordIOChunkReader`` — used by the recordio
    InputSplit, whose chunks are aligned on magic boundaries, so parsing is
    pure in-memory slicing.  This is the TPU-infeed-friendly path: one
    storage read produces a chunk, records are sliced out without copies
    where possible.
    """

    def __init__(self, chunk: bytes):
        self._view = memoryview(chunk)
        self._pos = 0

    def next_record(self) -> Optional[bytes]:
        parts: list[bytes] = []
        view, pos = self._view, self._pos
        while True:
            if pos >= len(view):
                CHECK(not parts, "RecordIO chunk: truncated multi-part record")
                self._pos = pos
                return None
            if pos + 8 > len(view):
                log_fatal("RecordIO chunk: truncated header")
            magic = _U32.unpack_from(view, pos)[0]
            CHECK_EQ(magic, RECORDIO_MAGIC, "RecordIO chunk: bad magic")
            lrec = _U32.unpack_from(view, pos + 4)[0]
            cflag, clen = decode_flag(lrec), decode_length(lrec)
            data_end = pos + 8 + clen
            if data_end > len(view):
                log_fatal("RecordIO chunk: truncated payload")
            if cflag in (0, 1):
                CHECK(not parts, "RecordIO chunk: unexpected start flag")
            if cflag in (2, 3):
                parts.append(RECORDIO_MAGIC_BYTES)
            parts.append(bytes(view[pos + 8 : data_end]))
            pos = pos + 8 + (((clen + 3) >> 2) << 2)
            if cflag in (0, 3):
                self._pos = min(pos, len(view))
                return b"".join(parts)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec
