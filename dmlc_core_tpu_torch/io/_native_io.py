"""ctypes bindings for the native I/O hot loops (``cpp/recordio.cc``,
``cpp/prefetch.cc``).

Covers the RecordIO batch framing fast paths (``cpp/recordio.cc``) and the
threaded chunk prefetcher (``cpp/prefetch.cc``) — the native counterparts
of the reference's ``src/recordio.cc`` and ``src/io/threaded_input_split.h``
(SURVEY.md §2b).  Like the parse bindings (``data/_native.py``), everything
here is optional: callers fall back to the pure-Python paths when the
library is absent (``base/_native_build.py`` builds it on first use) or
``DMLC_TPU_NATIVE_IO=0``.

Each entry counts its calls (:func:`calls`: ``recordio_encode``,
``recordio_decode``, ``prefetch_open`` and ``prefetch_chunks``, the
chunks a :class:`NativeChunkReader` handed out), so a caller can prove
which route ran.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from dmlc_core_tpu_torch.base import _native_build

__all__ = [
    "native_io_available",
    "recordio_encode",
    "recordio_decode",
    "NativeChunkReader",
    "calls",
    "reset_calls",
]

#: calls of each native entry in this process
_CALLS = {"recordio_encode": 0, "recordio_decode": 0, "prefetch_open": 0,
          "prefetch_chunks": 0}
_CALLS_LOCK = threading.Lock()


def _count(entry: str) -> None:
    with _CALLS_LOCK:
        _CALLS[entry] += 1


def calls() -> Dict[str, int]:
    """``{entry: calls}`` of the native I/O entries in this process."""
    with _CALLS_LOCK:
        return dict(_CALLS)


def reset_calls() -> None:
    with _CALLS_LOCK:
        for k in _CALLS:
            _CALLS[k] = 0


class _DmlcBuf(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_char)),
        ("len", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
    ]


_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("DMLC_TPU_NATIVE_IO", "1") == "0":
        _load_failed = True
        return None
    path = _native_build.library_path()      # raises on a failed build
    if path is None:
        _load_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.dmlc_recordio_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(_DmlcBuf)]
    lib.dmlc_recordio_encode.restype = ctypes.c_int
    lib.dmlc_recordio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_DmlcBuf)]
    lib.dmlc_recordio_decode.restype = ctypes.c_int
    lib.dmlc_buf_free.argtypes = [ctypes.POINTER(_DmlcBuf)]
    lib.dmlc_buf_free.restype = None
    lib.dmlc_prefetch_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32]
    lib.dmlc_prefetch_open.restype = ctypes.c_void_p
    lib.dmlc_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.dmlc_prefetch_next.restype = ctypes.c_int
    lib.dmlc_prefetch_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.dmlc_prefetch_free.restype = None
    lib.dmlc_prefetch_error.argtypes = [ctypes.c_void_p]
    lib.dmlc_prefetch_error.restype = ctypes.c_char_p
    lib.dmlc_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.dmlc_prefetch_close.restype = None
    _lib = lib
    return lib


def native_io_available() -> bool:
    return _load() is not None


def recordio_encode(records: Sequence[bytes]) -> bytes:
    """Frame ``records`` into one RecordIO byte stream (native)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io library not available")
    _count("recordio_encode")
    data = b"".join(records)
    offsets = (ctypes.c_int64 * (len(records) + 1))()
    acc = 0
    for i, r in enumerate(records):
        offsets[i] = acc
        acc += len(r)
    offsets[len(records)] = acc
    buf = _DmlcBuf()
    rc = lib.dmlc_recordio_encode(data, offsets, len(records), ctypes.byref(buf))
    if rc != 0:
        msg = buf.error.decode("utf-8", "replace")
        lib.dmlc_buf_free(ctypes.byref(buf))
        raise ValueError(f"recordio encode failed: {msg}")
    out = ctypes.string_at(buf.data, buf.len)
    lib.dmlc_buf_free(ctypes.byref(buf))
    return out


def recordio_decode(chunk: bytes) -> List[bytes]:
    """Decode a chunk of complete RecordIO records (native)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native io library not available")
    _count("recordio_decode")
    buf = _DmlcBuf()
    rc = lib.dmlc_recordio_decode(chunk, len(chunk), ctypes.byref(buf))
    if rc != 0:
        msg = buf.error.decode("utf-8", "replace")
        lib.dmlc_buf_free(ctypes.byref(buf))
        raise ValueError(f"recordio decode failed: {msg}")
    payload = ctypes.string_at(buf.data, buf.len)
    n = buf.n
    offs = [buf.offsets[i] for i in range(n + 1)]
    lib.dmlc_buf_free(ctypes.byref(buf))
    return [payload[offs[i]:offs[i + 1]] for i in range(n)]


class NativeChunkReader:
    """Background-thread chunk reader over local-file byte-range segments.

    Produces the same ``(file_index, bytes)`` sequence as the Python
    ``InputSplitBase`` sequential read path; used as its storage-read fast
    path so the byte-range sharding oracle holds for both.
    """

    def __init__(self, segments: Sequence[Tuple[str, int, int]],
                 chunk_size: int, capacity: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native io library not available")
        self._lib = lib
        n = len(segments)
        paths = (ctypes.c_char_p * n)(*[s[0].encode() for s in segments])
        begins = (ctypes.c_int64 * n)(*[s[1] for s in segments])
        ends = (ctypes.c_int64 * n)(*[s[2] for s in segments])
        self._handle = lib.dmlc_prefetch_open(
            paths, begins, ends, n, chunk_size, capacity)
        if not self._handle:
            raise RuntimeError("native prefetch open failed")
        _count("prefetch_open")

    def next(self) -> Optional[Tuple[int, bytes]]:
        """Next (segment_index, chunk) or None at EOF; raises on IO error."""
        data = ctypes.POINTER(ctypes.c_char)()
        length = ctypes.c_int64()
        fidx = ctypes.c_int32()
        rc = self._lib.dmlc_prefetch_next(
            self._handle, ctypes.byref(data), ctypes.byref(length),
            ctypes.byref(fidx))
        if rc == 0:
            return None
        if rc < 0:
            msg = self._lib.dmlc_prefetch_error(self._handle)
            raise IOError(f"native prefetch: "
                          f"{msg.decode('utf-8', 'replace') if msg else 'unknown'}")
        out = ctypes.string_at(data, length.value)
        self._lib.dmlc_prefetch_free(data)
        _count("prefetch_chunks")
        return fidx.value, out

    def close(self) -> None:
        if self._handle:
            self._lib.dmlc_prefetch_close(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
