"""The central Stream abstraction with URI dispatch.

Reference parity: ``include/dmlc/io.h :: dmlc::Stream (Read/Write,
Create(uri, flag, allow_null)), SeekStream (Seek/Tell/CreateForRead),
Serializable`` and ``src/io.cc :: Stream::Create`` URI routing
(SURVEY.md §2a-b).

Checkpoints, RecordIO files, row-block caches and parameter JSON all flow
through this one interface, so a consumer can point any of them at
``file://``, ``mem://`` or (later) remote backends without code changes —
exactly the property XGBoost/MXNet relied on in the reference.

This package's own copy of ``dmlc_core_tpu.io.stream``; the filesystems
behind it are ``io.filesystem``'s (local files and ``mem://``).
"""

from __future__ import annotations

import abc
import io
import sys
from typing import Any, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal

__all__ = ["Stream", "SeekStream", "Serializable"]


class Stream(abc.ABC):
    """Abstract byte stream.

    Subclasses implement :meth:`read` and :meth:`write`; everything else
    (typed binary helpers, context management) is provided here.
    """

    # -- core interface --------------------------------------------------
    @abc.abstractmethod
    def read(self, nbytes: int) -> bytes:
        """Read up to ``nbytes`` bytes; b"" at EOF.  ``nbytes=-1`` → all."""

    @abc.abstractmethod
    def write(self, data: bytes) -> int:
        """Write all of ``data``; return number of bytes written."""

    def close(self) -> None:
        pass

    def flush(self) -> None:
        pass

    # -- convenience -----------------------------------------------------
    def read_exact(self, nbytes: int) -> bytes:
        """Read exactly ``nbytes`` or fatal (truncated stream)."""
        chunks: list[bytes] = []
        remaining = nbytes
        while remaining > 0:
            chunk = self.read(remaining)
            if not chunk:
                log_fatal(
                    f"Stream: unexpected EOF, wanted {nbytes} bytes, got {nbytes - remaining}"
                )
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def read_all(self) -> bytes:
        chunks: list[bytes] = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def as_file(self):
        """A Python file object over this stream.

        Reference parity: ``include/dmlc/io.h :: dmlc::ostream/istream``
        (streambuf adapters) — lets std-library code that wants a file
        (pickle, json.dump, np.save, TextIOWrapper…) write through any
        Stream backend.  Closing the file object does NOT close the
        underlying stream.
        """
        return _StreamFile(self)

    # -- URI dispatch ----------------------------------------------------
    @staticmethod
    def create(uri: str, mode: str = "r", allow_null: bool = False) -> Optional["Stream"]:
        """Open a stream by URI.

        Reference parity: ``Stream::Create(uri, flag, allow_null)`` — routes
        ``file://``, ``mem://`` … by protocol via the filesystem registry;
        a bare path means local; ``"stdin"``/``"stdout"`` map to the process
        streams.  ``mode`` is ``"r"``, ``"w"`` or ``"a"``.
        """
        from dmlc_core_tpu_torch.io.filesystem import FileSystem, URI

        CHECK(mode in ("r", "w", "a"), f"invalid stream mode {mode!r}")
        if uri == "stdin":
            return _StdStream(sys.stdin.buffer)
        if uri == "stdout":
            return _StdStream(sys.stdout.buffer)
        parsed = URI(uri)
        fs = FileSystem.get_instance(parsed)
        if fs is None:
            if allow_null:
                return None
            log_fatal(f"Stream.create: no filesystem for protocol {parsed.protocol!r}")
        try:
            return fs.open(parsed, mode)
        except (OSError, IOError) as e:
            if allow_null:
                return None
            log_fatal(f"Stream.create({uri!r}, {mode!r}) failed: {e}")

    @staticmethod
    def create_for_read(uri: str, allow_null: bool = False) -> Optional["SeekStream"]:
        """Reference parity: ``SeekStream::CreateForRead``."""
        s = Stream.create(uri, "r", allow_null)
        if s is not None and not isinstance(s, SeekStream):
            log_fatal(f"Stream {uri!r} does not support seeking")
        return s  # type: ignore[return-value]


class SeekStream(Stream):
    """A stream with random access.  Reference: ``dmlc::SeekStream``."""

    @abc.abstractmethod
    def seek(self, pos: int) -> None:
        ...

    @abc.abstractmethod
    def tell(self) -> int:
        ...


class _StreamFile(io.RawIOBase):
    """io.RawIOBase view of a Stream (see :meth:`Stream.as_file`)."""

    def __init__(self, stream: "Stream"):
        self._stream = stream

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._stream.read(len(b))
        b[: len(data)] = data
        return len(data)

    def write(self, b) -> int:
        return self._stream.write(bytes(b))

    def flush(self) -> None:
        try:
            self._stream.flush()
        except ValueError:
            # underlying stream already closed (IOBase.close() flushes
            # unconditionally, incl. at GC) — the adapter promises closing
            # it is independent of the stream's lifetime
            pass

    def seekable(self) -> bool:
        return isinstance(self._stream, SeekStream)

    def seek(self, pos: int, whence: int = 0) -> int:
        CHECK(isinstance(self._stream, SeekStream),
              "as_file().seek on a non-seekable Stream")
        CHECK(whence == 0, "Stream.as_file only supports absolute seeks")
        self._stream.seek(pos)
        return pos

    def tell(self) -> int:
        CHECK(isinstance(self._stream, SeekStream),
              "as_file().tell on a non-seekable Stream")
        return self._stream.tell()


class _StdStream(Stream):
    """stdin/stdout as a Stream (the reference's `"stdin"` URI)."""

    def __init__(self, fileobj: Any):
        self._f = fileobj

    def read(self, nbytes: int) -> bytes:
        return self._f.read(nbytes) if nbytes >= 0 else self._f.read()

    def write(self, data: bytes) -> int:
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()


class Serializable(abc.ABC):
    """Objects that round-trip through a Stream.

    Reference parity: ``dmlc::Serializable`` — ``Save(Stream*)`` /
    ``Load(Stream*)``.
    """

    @abc.abstractmethod
    def save(self, stream: Stream) -> None:
        ...

    @abc.abstractmethod
    def load(self, stream: Stream) -> None:
        ...
