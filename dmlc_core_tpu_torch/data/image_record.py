"""Image records over RecordIO — the ImageNet shard format (config 2).

This package's own copy of ``dmlc_core_tpu/data/image_record.py``: the
same header, the same bytes and the same batches for the same shard,
``part``, ``nparts``, ``shuffle_buffer`` and ``seed``.  Its records come
out of the ``recordio`` input split, which decodes each chunk with the
native RecordIO codec (``io/_native_io.recordio_decode``) where the
native library is present.

Reference parity: MXNet's ``.rec`` image pipeline is RecordIO records of
``IRHeader + payload`` consumed through ``InputSplit::Create(uri, part,
nparts, "recordio")`` (SURVEY.md §3.2).  The header here mirrors IRHeader's
fields (flag, label, id) plus an explicit shape so tests and synthetic
data can carry raw tensors; payload is either raw uint8 HWC bytes
(``flag=0``) or an encoded image (``flag=1``, decoder pluggable — JPEG
decode is host-side and orthogonal to the substrate).

``batch_iterator`` is the host half of BASELINE config 2's pipeline:
RecordIO shard → records → fixed-shape ``(images[B,H,W,C] u8,
labels[B] i32)`` numpy batches, ready for :class:`DeviceFeed`.
"""

from __future__ import annotations

import struct
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ
from dmlc_core_tpu_torch.io.input_split import InputSplit

__all__ = ["pack_image_record", "unpack_image_record", "batch_iterator"]

# flag:u32  label:f32  id:u64  h:u16 w:u16 c:u16  (little-endian)
_HEADER = struct.Struct("<IfQHHH")


def pack_image_record(
    image: np.ndarray,
    label: float,
    record_id: int = 0,
    flag: int = 0,
) -> bytes:
    """Serialize one image record (raw uint8 HWC when ``flag=0``)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    CHECK_EQ(img.ndim, 3, "image must be HWC")
    h, w, c = img.shape
    return _HEADER.pack(flag, float(label), record_id, h, w, c) + img.tobytes()


def unpack_image_record(
    rec: bytes,
    decoder: Optional[Callable[[bytes, Tuple[int, int, int]], np.ndarray]] = None,
) -> Tuple[np.ndarray, float, int]:
    """Parse one record → (image u8 HWC, label, id)."""
    CHECK(len(rec) >= _HEADER.size, "image record too short")
    flag, label, rid, h, w, c = _HEADER.unpack_from(rec)
    payload = rec[_HEADER.size:]
    if flag == 0:
        img = np.frombuffer(payload, dtype=np.uint8)
        CHECK_EQ(img.size, h * w * c, "image record payload size mismatch")
        img = img.reshape(h, w, c)
    else:
        CHECK(decoder is not None, "encoded image record needs a decoder")
        img = decoder(payload, (h, w, c))
    return img, label, rid


def batch_iterator(
    uri: str,
    part: int,
    nparts: int,
    batch_size: int,
    image_shape: Tuple[int, int, int],
    decoder: Optional[Callable[[bytes, Tuple[int, int, int]], np.ndarray]] = None,
    drop_last: bool = True,
    shuffle_buffer: int = 0,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream ``(images[B,H,W,C] u8, labels[B] i32)`` batches from a
    RecordIO shard — this worker reads only its byte range
    (``part``/``nparts``), the reference's input-sharding contract.
    """
    h, w, c = image_shape
    split = InputSplit.create(uri, part, nparts, "recordio",
                              shuffle_buffer=shuffle_buffer, seed=seed)
    images = np.empty((batch_size, h, w, c), np.uint8)
    labels = np.empty(batch_size, np.int32)
    fill = 0
    try:
        for rec in split:
            img, label, _rid = unpack_image_record(rec, decoder)
            CHECK_EQ(img.shape, (h, w, c), "image shape mismatch in shard")
            images[fill] = img
            labels[fill] = int(label)
            fill += 1
            if fill == batch_size:
                yield images.copy(), labels.copy()
                fill = 0
        if fill and not drop_last:
            yield images[:fill].copy(), labels[:fill].copy()
    finally:
        split.close()
