"""PS wire framing: one JSON header line + raw array payload.

The tracker's protocol is newline-delimited JSON (tracker/tracker.py);
the PS data plane keeps that idiom for the *header* — every message
starts with one JSON line carrying ``cmd`` and metadata — but gradients
and weights ride AFTER the header as raw little-endian bytes, described
by an ``arrays`` descriptor list in the header.  JSON-encoding a
100k-float gradient batch would cost ~10x the bytes and a parse per
element; raw frames keep ``keys_per_sec`` a function of the socket, not
the codec.

Framing::

    {"cmd": "push", ..., "arrays": [{"dtype": "float32",
                                     "shape": [N]}, ...]}\\n
    <array 0 bytes><array 1 bytes>...

Both sides speak through a buffered socket file (``sock.makefile``), so
partial reads/writes are absorbed by the file object.
"""

from __future__ import annotations

import json
from typing import Any, BinaryIO, Dict, List, Sequence, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import tracectx as _tracectx
from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["send_msg", "recv_msg"]

#: refuse to allocate for absurd descriptors (a garbled header must not
#: OOM the receiver) — 1 GiB per array is far above any real PS frame
_MAX_ARRAY_BYTES = 1 << 30


def send_msg(f: BinaryIO, header: Dict[str, Any],
             arrays: Sequence[np.ndarray] = ()) -> None:
    """Write one framed message: JSON header line, then each array's
    raw bytes in order.  The ``arrays`` descriptor is appended to the
    header automatically."""
    desc = []
    blobs: List[bytes] = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        desc.append({"dtype": str(a.dtype), "shape": list(a.shape)})
        blobs.append(a.tobytes())
    msg = dict(header)
    msg["arrays"] = desc
    # distributed trace context rides the framing layer (declared in
    # base/wire_schemas.WIRE_FRAMING), so every PS hop is correlated
    # without per-call-site plumbing; a no-op when DMLC_TRACE is off
    trace = _tracectx.current_header()
    if trace is not None:
        msg.setdefault(_tracectx.WIRE_KEY, trace)
    f.write(json.dumps(msg).encode() + b"\n")
    for b in blobs:
        f.write(b)
    f.flush()


def recv_msg(f: BinaryIO) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """Read one framed message; returns ``(header, arrays)``.  Raises
    ``ConnectionError`` on EOF (peer closed) — callers treat that as
    the liveness signal, exactly like the tracker's serve loop."""
    line = f.readline()
    if not line:
        raise ConnectionError("ps wire: peer closed")
    header = json.loads(line)
    arrays: List[np.ndarray] = []
    for d in header.pop("arrays", []):
        dtype = np.dtype(d["dtype"])
        shape = tuple(int(s) for s in d["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        CHECK(0 <= nbytes <= _MAX_ARRAY_BYTES,
              f"ps wire: bad array frame ({nbytes} bytes)")
        buf = f.read(nbytes)
        if len(buf) != nbytes:
            raise ConnectionError("ps wire: truncated array frame")
        arrays.append(np.frombuffer(buf, dtype).reshape(shape))
    return header, arrays
