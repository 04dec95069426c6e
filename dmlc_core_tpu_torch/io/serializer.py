"""Endian-stable binary serialization over Streams.

Reference parity: ``include/dmlc/serializer.h :: Handler<T>,
ArithmeticHandler, NativePODHandler, CompositeVectorHandler`` + the
``include/dmlc/endian.h`` byte-order rules (SURVEY.md §2a).

The wire format is canonical **little-endian** (the reference's
``DMLC_IO_NO_ENDIAN_SWAP`` fast path on x86 hosts), with the same
framing the reference uses: ``uint64 size`` before containers, raw POD
bytes for scalars.  Where C++ dispatches on ``T`` at compile time, Python
dispatches on runtime type (scalars/str/bytes/list/tuple/dict/set/numpy
array/Serializable), with explicit ``write_*``/``read_*`` primitives for
schema-stable framing.  numpy arrays serialize as dtype + shape + raw
buffer.

This package's own copy of ``dmlc_core_tpu.io.serializer``: the same bytes
for the same objects, so model files written by either package load in the
other.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Sequence

import numpy as np

from dmlc_core_tpu_torch.base.logging import log_fatal
from dmlc_core_tpu_torch.io.stream import Serializable, Stream

__all__ = [
    "write_uint32", "read_uint32", "write_uint64", "read_uint64",
    "write_int32", "read_int32", "write_int64", "read_int64",
    "write_float32", "read_float32", "write_float64", "read_float64",
    "write_bool", "read_bool",
    "write_string", "read_string", "write_bytes", "read_bytes",
    "write_vector", "read_vector", "write_ndarray", "read_ndarray",
    "write_obj", "read_obj",
]

# -- scalar primitives (canonical little-endian) -------------------------

def _make_scalar(fmt: str):
    packer = struct.Struct("<" + fmt)
    tname = {"I": "uint32", "Q": "uint64", "i": "int32", "q": "int64",
             "f": "float32", "d": "float64", "?": "bool"}[fmt]

    def write(stream: Stream, value) -> None:
        stream.write(packer.pack(value))

    def read(stream: Stream):
        return packer.unpack(stream.read_exact(packer.size))[0]

    write.__doc__ = (f"Write one little-endian ``{tname}`` to ``stream`` "
                     f"(canonical wire scalar; reference serializer.h).")
    read.__doc__ = (f"Read one little-endian ``{tname}`` from ``stream`` "
                    f"(canonical wire scalar; reference serializer.h).")
    write.__name__ = f"write_{tname}"
    read.__name__ = f"read_{tname}"
    return write, read


write_uint32, read_uint32 = _make_scalar("I")
write_uint64, read_uint64 = _make_scalar("Q")
write_int32, read_int32 = _make_scalar("i")
write_int64, read_int64 = _make_scalar("q")
write_float32, read_float32 = _make_scalar("f")
write_float64, read_float64 = _make_scalar("d")
write_bool, read_bool = _make_scalar("?")


def write_bytes(stream: Stream, data: bytes) -> None:
    """uint64 length + raw bytes (the reference's string framing)."""
    write_uint64(stream, len(data))
    stream.write(bytes(data))


def read_bytes(stream: Stream) -> bytes:
    """Read a uint64-length-prefixed byte string (inverse of
    :func:`write_bytes`)."""
    n = read_uint64(stream)
    return stream.read_exact(n)


def write_string(stream: Stream, s: str) -> None:
    """Write ``s`` UTF-8 encoded with uint64 length prefix (reference
    string framing)."""
    write_bytes(stream, s.encode("utf-8"))


def read_string(stream: Stream) -> str:
    """Read a UTF-8 string written by :func:`write_string`."""
    return read_bytes(stream).decode("utf-8")


# -- containers ----------------------------------------------------------

def write_vector(stream: Stream, seq: Sequence[Any],
                 write_elem: Callable[[Stream, Any], None]) -> None:
    """uint64 size + elements.  Reference: ``CompositeVectorHandler``."""
    write_uint64(stream, len(seq))
    for item in seq:
        write_elem(stream, item)


def read_vector(stream: Stream, read_elem: Callable[[Stream], Any]) -> List[Any]:
    """Read a uint64-count-prefixed sequence, decoding each element with
    ``read_elem`` (inverse of :func:`write_vector`)."""
    n = read_uint64(stream)
    return [read_elem(stream) for _ in range(n)]


# -- numpy (the checkpoint primitive) --------------------------------

def write_ndarray(stream: Stream, arr: np.ndarray) -> None:
    """dtype-str + ndim + shape + raw little-endian buffer.

    Device tensors travel as their host numpy view (``t.cpu().numpy()``).
    """
    arr = np.ascontiguousarray(arr)
    canon = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
    arr = arr.astype(canon, copy=False)
    write_string(stream, arr.dtype.str)
    write_uint32(stream, arr.ndim)
    for dim in arr.shape:
        write_uint64(stream, dim)
    stream.write(arr.tobytes())


def read_ndarray(stream: Stream) -> np.ndarray:
    """Read a numpy array written by :func:`write_ndarray` (dtype string +
    shape + raw little-endian buffer)."""
    dtype = np.dtype(read_string(stream))
    ndim = read_uint32(stream)
    shape = tuple(read_uint64(stream) for _ in range(ndim))
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
    if len(shape) == 0:
        return np.frombuffer(stream.read_exact(dtype.itemsize), dtype=dtype)[0]
    return np.frombuffer(stream.read_exact(nbytes), dtype=dtype).reshape(shape).copy()


# -- tagged generic object serialization ---------------------------------
# The C++ serializer is untagged (type known at compile time); Python needs
# one tag byte for the equivalent "Stream::Write(obj) just works" ergonomics.

_TAG_NONE, _TAG_BOOL, _TAG_INT, _TAG_FLOAT, _TAG_STR, _TAG_BYTES = range(6)
_TAG_LIST, _TAG_TUPLE, _TAG_DICT, _TAG_SET, _TAG_NDARRAY, _TAG_SERIALIZABLE = range(6, 12)


def write_obj(stream: Stream, obj: Any) -> None:
    """Serialize a nested Python object (the ``Stream::Write(vector<pair<..>>)
    just works`` ergonomics, with a 1-byte type tag)."""
    if obj is None:
        stream.write(bytes([_TAG_NONE]))
    elif isinstance(obj, bool):
        stream.write(bytes([_TAG_BOOL]))
        write_bool(stream, obj)
    elif isinstance(obj, int):
        stream.write(bytes([_TAG_INT]))
        write_int64(stream, obj)
    elif isinstance(obj, float):
        stream.write(bytes([_TAG_FLOAT]))
        write_float64(stream, obj)
    elif isinstance(obj, str):
        stream.write(bytes([_TAG_STR]))
        write_string(stream, obj)
    elif isinstance(obj, (bytes, bytearray)):
        stream.write(bytes([_TAG_BYTES]))
        write_bytes(stream, bytes(obj))
    elif isinstance(obj, list):
        stream.write(bytes([_TAG_LIST]))
        write_vector(stream, obj, write_obj)
    elif isinstance(obj, tuple):
        stream.write(bytes([_TAG_TUPLE]))
        write_vector(stream, obj, write_obj)
    elif isinstance(obj, dict):
        stream.write(bytes([_TAG_DICT]))
        write_uint64(stream, len(obj))
        for k, v in obj.items():
            write_obj(stream, k)
            write_obj(stream, v)
    elif isinstance(obj, (set, frozenset)):
        stream.write(bytes([_TAG_SET]))
        write_vector(stream, sorted(obj), write_obj)
    elif isinstance(obj, np.ndarray) or np.isscalar(obj) and hasattr(obj, "dtype"):
        stream.write(bytes([_TAG_NDARRAY]))
        write_ndarray(stream, np.asarray(obj))
    elif isinstance(obj, Serializable):
        stream.write(bytes([_TAG_SERIALIZABLE]))
        obj.save(stream)
    else:
        log_fatal(f"write_obj: unsupported type {type(obj).__name__}")


def read_obj(stream: Stream, serializable_factory: Callable[[], Any] | None = None) -> Any:
    """Read one object written by :func:`write_obj` — scalars, strings,
    bytes, numpy arrays, and nested list/tuple/dict/set containers;
    ``serializable_factory`` constructs application objects that
    implement the Serializable protocol."""
    tag = stream.read_exact(1)[0]
    if tag == _TAG_NONE:
        return None
    if tag == _TAG_BOOL:
        return read_bool(stream)
    if tag == _TAG_INT:
        return read_int64(stream)
    if tag == _TAG_FLOAT:
        return read_float64(stream)
    if tag == _TAG_STR:
        return read_string(stream)
    if tag == _TAG_BYTES:
        return read_bytes(stream)
    if tag == _TAG_LIST:
        return read_vector(stream, lambda s: read_obj(s, serializable_factory))
    if tag == _TAG_TUPLE:
        return tuple(read_vector(stream, lambda s: read_obj(s, serializable_factory)))
    if tag == _TAG_DICT:
        n = read_uint64(stream)
        return {
            read_obj(stream, serializable_factory): read_obj(stream, serializable_factory)
            for _ in range(n)
        }
    if tag == _TAG_SET:
        return set(read_vector(stream, lambda s: read_obj(s, serializable_factory)))
    if tag == _TAG_NDARRAY:
        return read_ndarray(stream)
    if tag == _TAG_SERIALIZABLE:
        if serializable_factory is None:
            log_fatal("read_obj: Serializable payload but no factory given")
        obj = serializable_factory()
        obj.load(stream)
        return obj
    log_fatal(f"read_obj: bad tag {tag}")
