"""In-memory streams — also the unit tests' mock streams.

Reference parity: ``include/dmlc/memory_io.h :: MemoryFixedSizeStream,
MemoryStringStream`` (SURVEY.md §2a).

This package's own copy of ``dmlc_core_tpu.io.memory_io``.
"""

from __future__ import annotations

from dmlc_core_tpu_torch.base.logging import log_fatal
from dmlc_core_tpu_torch.io.stream import SeekStream

__all__ = ["MemoryFixedSizeStream", "MemoryStringStream"]


class MemoryFixedSizeStream(SeekStream):
    """Stream over a caller-provided fixed-size buffer.

    Writes past the end are fatal (the reference CHECKs the same way).
    The buffer must support the buffer protocol and be mutable for writes
    (e.g. ``bytearray``, ``memoryview``, writable numpy array).
    """

    def __init__(self, buffer) -> None:
        self._buf = memoryview(buffer).cast("B")
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        if nbytes < 0:
            nbytes = len(self._buf) - self._pos
        end = min(self._pos + nbytes, len(self._buf))
        out = bytes(self._buf[self._pos : end])
        self._pos = end
        return out

    def write(self, data: bytes) -> int:
        end = self._pos + len(data)
        if end > len(self._buf):
            log_fatal(
                f"MemoryFixedSizeStream: write of {len(data)} bytes at {self._pos} "
                f"overflows buffer of {len(self._buf)}"
            )
        self._buf[self._pos : end] = data
        self._pos = end
        return len(data)

    def seek(self, pos: int) -> None:
        if not 0 <= pos <= len(self._buf):
            log_fatal(f"MemoryFixedSizeStream: seek({pos}) out of range")
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class MemoryStringStream(SeekStream):
    """Growable stream over a ``bytearray`` (the reference's std::string).

    ``data`` exposes the underlying buffer for round-trip tests::

        s = MemoryStringStream()
        s.write(b"abc"); s.seek(0); assert s.read(-1) == b"abc"
    """

    def __init__(self, data: bytearray | None = None) -> None:
        self.data = data if data is not None else bytearray()
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        if nbytes < 0:
            nbytes = len(self.data) - self._pos
        end = min(self._pos + nbytes, len(self.data))
        out = bytes(self.data[self._pos : end])
        self._pos = end
        return out

    def write(self, data: bytes) -> int:
        end = self._pos + len(data)
        if end > len(self.data):
            self.data.extend(b"\x00" * (end - len(self.data)))
        self.data[self._pos : end] = data
        self._pos = end
        return len(data)

    def seek(self, pos: int) -> None:
        if not 0 <= pos <= len(self.data):
            log_fatal(f"MemoryStringStream: seek({pos}) out of range")
        self._pos = pos

    def tell(self) -> int:
        return self._pos
