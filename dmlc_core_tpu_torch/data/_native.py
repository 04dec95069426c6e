"""ctypes binding to the native parse hot loop (``cpp/fastparse.cc``).

The library is optional: every caller falls back to the pure-numpy path
when it is absent (``native_available() == False``), so the package works
untouched in environments without a toolchain.  ``base/_native_build.py``
builds it on first use under ``build/``.

Each entry counts its calls (:func:`calls`), so a caller can prove which
route parsed its rows.

Buffers returned by the native parser are wrapped zero-copy as numpy arrays
whose lifetime is tied to a finalizer that calls ``dmlc_rows_free``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from dmlc_core_tpu_torch.base import _native_build
from dmlc_core_tpu_torch.base.logging import Error

__all__ = ["native_available", "num_threads", "parse_libsvm", "parse_csv",
           "parse_libfm", "calls", "reset_calls"]

#: calls of each native entry in this process
_CALLS = {"parse_libsvm": 0, "parse_csv": 0, "parse_libfm": 0}
_CALLS_LOCK = threading.Lock()


def calls() -> Dict[str, int]:
    """``{entry: calls}`` of the native parse entries in this process."""
    with _CALLS_LOCK:
        return dict(_CALLS)


def reset_calls() -> None:
    with _CALLS_LOCK:
        for k in _CALLS:
            _CALLS[k] = 0


class _DmlcRows(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("offset", ctypes.POINTER(ctypes.c_int64)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("qid", ctypes.POINTER(ctypes.c_int64)),
        ("field", ctypes.POINTER(ctypes.c_int32)),
        ("index", ctypes.POINTER(ctypes.c_int64)),
        ("value", ctypes.POINTER(ctypes.c_float)),
        ("has_weight", ctypes.c_int32),
        ("has_qid", ctypes.c_int32),
        ("has_field", ctypes.c_int32),
        ("has_value", ctypes.c_int32),
        ("error", ctypes.c_char * 256),
    ]


_lib: Optional[ctypes.CDLL] = None
_absent = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _absent
    if _lib is not None or _absent:
        return _lib
    path = _native_build.library_path()      # raises on a failed build
    if path is None:
        _absent = True
        return None
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in (
        ("dmlc_parse_libsvm",
         [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(_DmlcRows)]),
        ("dmlc_parse_csv",
         [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int64,
          ctypes.c_int64, ctypes.c_int, ctypes.POINTER(_DmlcRows)]),
        ("dmlc_parse_libfm",
         [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(_DmlcRows)]),
    ):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.dmlc_rows_free.argtypes = [ctypes.POINTER(_DmlcRows)]
    lib.dmlc_rows_free.restype = None
    lib.dmlc_num_threads.argtypes = []
    lib.dmlc_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def num_threads() -> int:
    """The native parser's default thread count: OpenMP's, or 1 where the
    library was built without OpenMP (``base/_native_build.py``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    return int(lib.dmlc_num_threads())


def _as_np(ptr, n, dtype):
    if not ptr or n == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,))


def _collect(rows: _DmlcRows, lib: ctypes.CDLL) -> dict:
    """Copy native buffers into numpy arrays and free the arena.

    A copy (rather than a finalizer-tied view) keeps ownership simple; the
    copy cost is dwarfed by parse time and the buffers are short-lived.
    """
    n, nnz = rows.n_rows, rows.nnz
    out = {
        "offset": _as_np(rows.offset, n + 1, np.int64).copy(),
        "label": _as_np(rows.label, n, np.float32).copy(),
        "index": _as_np(rows.index, nnz, np.int64).copy(),
        "value": _as_np(rows.value, nnz, np.float32).copy() if rows.has_value else None,
        "weight": _as_np(rows.weight, n, np.float32).copy() if rows.has_weight else None,
        "qid": _as_np(rows.qid, n, np.int64).copy() if rows.has_qid else None,
        "field": _as_np(rows.field, nnz, np.int32).copy() if rows.has_field else None,
    }
    lib.dmlc_rows_free(ctypes.byref(rows))
    return out


def _run(fn_name: str, data: bytes, *args, nthread: int = 0) -> dict:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    with _CALLS_LOCK:
        _CALLS[fn_name[len("dmlc_"):]] += 1
    rows = _DmlcRows()
    rc = getattr(lib, fn_name)(data, len(data), *args, nthread, ctypes.byref(rows))
    if rc != 0:
        msg = rows.error.decode("utf-8", "replace")
        lib.dmlc_rows_free(ctypes.byref(rows))
        raise Error(f"native parse failed: {msg}")
    return _collect(rows, lib)


def parse_libsvm(data: bytes, nthread: int = 0) -> dict:
    return _run("dmlc_parse_libsvm", data, nthread=nthread)


def parse_csv(data: bytes, delimiter: str = ",", label_col: int = 0,
              weight_col: int = -1, nthread: int = 0) -> dict:
    return _run(
        "dmlc_parse_csv", data, delimiter.encode()[:1], label_col, weight_col,
        nthread=nthread,
    )


def parse_libfm(data: bytes, nthread: int = 0) -> dict:
    return _run("dmlc_parse_libfm", data, nthread=nthread)
