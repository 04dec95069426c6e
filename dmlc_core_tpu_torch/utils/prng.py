"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``.

The JAX package samples rows and features with ``jax.random`` under its
defaults (``threefry2x32`` with ``jax_threefry_partitionable``).  So that a
sampled fit of this package draws the same masks, this module repeats
those algorithms in torch ops:

* :func:`key` — ``jax.random.key(seed)`` with 64-bit types off: the words
  ``(0, seed mod 2^32)``;
* :func:`split` — ``jax.random.split``: key ``i`` is the hash of the
  counter pair ``(0, i)``;
* :func:`fold_in` — ``jax.random.fold_in``: the hash of ``(0, data)``;
* :func:`random_bits` — 32-bit draws: element ``i`` (row-major) is
  ``b1 ^ b2`` for the hash ``(b1, b2)`` of the counter pair ``(i >> 32,
  i & 0xffffffff)``, so it depends on ``i`` alone;
* :func:`uniform` — ``jax.random.uniform`` in f32: the top 23 bits as a
  mantissa of ``[1, 2)``, minus 1.

A key is an int64 tensor ``[2]`` (a split's output ``[num, 2]``) whose
entries hold unsigned 32-bit words.  Words live in int64 and are masked
after every add and rotate: torch's ``>>`` on int32 is arithmetic, and
its uint32 support is partial on CUDA.  The draws run on the device asked
for (the key's words enter as scalars); host and card give the same bits,
being integer work.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

__all__ = ["key", "split", "fold_in", "random_bits", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def _threefry2x32(k1: Word, k2: Word, x0: torch.Tensor, x1: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0,
    x1)`` under the key ``(k1, k2)``: jax's ``threefry2x32`` lowering,
    unrolled."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(k: torch.Tensor) -> Tuple[int, int]:
    k1, k2 = (int(v) for v in k.reshape(2).tolist())
    return k1, k2


def key(seed: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.key(seed)``'s words: ``(0, seed mod 2^32)`` (the high
    word is 0 with 64-bit types off)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)``: ``[num, 2]`` keys."""
    k1, k2 = _words(k)
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` (``data`` taken mod 2^32)."""
    k1, k2 = _words(k)
    x = torch.tensor([0, int(data) & _MASK], dtype=torch.int64,
                     device=k.device)
    b1, b2 = _threefry2x32(k1, k2, x[:1], x[1:])
    return torch.cat([b1, b2])


def random_bits(k: torch.Tensor, shape: Sequence[int],
                device: Optional[torch.device] = None) -> torch.Tensor:
    """32-bit draws of ``shape`` (int64 holding uint32) on ``device``
    (default: the key's) — jax's partitionable ``random_bits``."""
    k1, k2 = _words(k)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64,
                     device=k.device if device is None else device)
    b1, b2 = _threefry2x32(k1, k2, i >> 32, i & _MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(k: torch.Tensor, shape: Sequence[int],
            device: Optional[torch.device] = None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: f32 in ``[0, 1)``."""
    bits = random_bits(k, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp(mant.view(torch.float32) - 1.0, min=0.0)
