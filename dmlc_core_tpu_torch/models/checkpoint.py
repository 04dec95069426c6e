"""Model checkpoints over the Stream / serializer layer (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/checkpoint.py``: one
magic-tagged payload written through ``Stream.create(uri)`` with the
port's own byte-compatible ``io.serializer``, so a file of either package
loads in the other.  Device tensors gather to host numpy arrays on save.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK_EQ
from dmlc_core_tpu_torch.io.serializer import read_obj, write_obj
from dmlc_core_tpu_torch.io.stream import Stream

__all__ = ["save_payload", "load_payload", "gather_tree"]


def save_payload(uri: str, magic: bytes, payload: Dict[str, Any]) -> None:
    """Write ``magic`` + one serialized payload dict to ``uri``."""
    s = Stream.create(uri, "w")
    try:
        s.write(magic)
        write_obj(s, payload)
    finally:
        s.close()


def load_payload(uri: str, magic: bytes) -> Dict[str, Any]:
    """Read back a payload written by :func:`save_payload`; the magic
    check fails loudly on a wrong-model or corrupt file."""
    s = Stream.create(uri, "r")
    try:
        got = bytes(s.read(len(magic)))
        CHECK_EQ(got, magic, f"wrong model magic in {uri}: {got!r}")
        return read_obj(s)
    finally:
        s.close()


def gather_tree(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A dict of tensors (on any device) or arrays as host numpy arrays,
    in the same key order."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}
