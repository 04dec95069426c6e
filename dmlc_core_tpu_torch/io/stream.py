"""The Stream abstraction with URI dispatch.

Reference parity: ``include/dmlc/io.h :: dmlc::Stream (Read/Write,
Create(uri, flag)), Serializable`` and
``src/io.cc :: Stream::Create`` URI routing (SURVEY.md §2a-b).

This package's own copy of the part of ``dmlc_core_tpu.io.stream`` (and of
its local / ``mem://`` filesystems) that model files need: local files
(``file://`` URIs and bare paths) and the in-process ``mem://``
filesystem.  Remote filesystems are not ported yet.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal

__all__ = ["Stream", "Serializable", "MemoryStringStream"]


class Stream(abc.ABC):
    """Abstract byte stream: subclasses implement :meth:`read` and
    :meth:`write`; typed helpers and context management live here."""

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

    def read_exact(self, nbytes: int) -> bytes:
        """Read exactly ``nbytes`` or fatal (truncated stream)."""
        chunks: list[bytes] = []
        remaining = nbytes
        while remaining > 0:
            chunk = self.read(remaining)
            if not chunk:
                log_fatal(f"Stream: unexpected EOF, wanted {nbytes} bytes, "
                          f"got {nbytes - remaining}")
            chunks.append(chunk)
            remaining -= len(chunk)
        return b"".join(chunks)

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    @staticmethod
    def create(uri: str, mode: str = "r") -> "Stream":
        """Open a stream by URI: ``file://path`` or a bare path (local),
        ``mem://name`` (in-process).  ``mode`` is ``"r"`` or ``"w"``."""
        CHECK(mode in ("r", "w"), f"invalid stream mode {mode!r}")
        proto, sep, rest = uri.partition("://")
        if not sep:
            proto, rest = "", uri
        # file:// and mem:// names are absolute, as in the reference URI
        name = rest if proto == "" or rest.startswith("/") else "/" + rest
        try:
            if proto in ("", "file"):
                return _LocalFileStream(name, mode)
            if proto == "mem":
                return _open_mem(name, mode)
        except OSError as e:
            log_fatal(f"Stream.create({uri!r}, {mode!r}) failed: {e}")
        log_fatal(f"Stream.create: no filesystem for protocol {proto + '://'!r}"
                  " (this package reads local files and mem:// only)")


class Serializable(abc.ABC):
    """Objects that round-trip through a Stream (``dmlc::Serializable``)."""

    @abc.abstractmethod
    def save(self, stream: Stream) -> None:
        ...

    @abc.abstractmethod
    def load(self, stream: Stream) -> None:
        ...


class _LocalFileStream(Stream):
    """Local file stream (Python files are 64-bit clean)."""

    def __init__(self, path: str, mode: str):
        self._f = open(path, mode + "b")

    def read(self, nbytes: int) -> bytes:
        return self._f.read(nbytes if nbytes >= 0 else None)

    def write(self, data: bytes) -> int:
        return self._f.write(data)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MemoryStringStream(Stream):
    """Growable stream over a ``bytearray`` (the reference's
    ``MemoryStringStream`` over a std::string)."""

    def __init__(self, data: Optional[bytearray] = None) -> None:
        self.data = data if data is not None else bytearray()
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        if nbytes < 0:
            nbytes = len(self.data) - self._pos
        end = min(self._pos + nbytes, len(self.data))
        out = bytes(self.data[self._pos:end])
        self._pos = end
        return out

    def write(self, data: bytes) -> int:
        end = self._pos + len(data)
        if end > len(self.data):
            self.data.extend(b"\x00" * (end - len(self.data)))
        self.data[self._pos:end] = data
        self._pos = end
        return len(data)


#: the ``mem://`` filesystem: name → committed bytes
_MEM_FILES: Dict[str, bytearray] = {}


class _MemCommitStream(MemoryStringStream):
    """A ``mem://`` writer that publishes its bytes on close, so a writer
    that dies mid-write leaves the previous object in place."""

    def __init__(self, key: str):
        super().__init__(bytearray())
        self._key = key

    def close(self) -> None:
        _MEM_FILES[self._key] = self.data


def _open_mem(key: str, mode: str) -> Stream:
    if mode == "r":
        if key not in _MEM_FILES:
            raise FileNotFoundError(f"mem://{key}")
        return MemoryStringStream(_MEM_FILES[key])
    return _MemCommitStream(key)

