"""Ulysses-style all-to-all sequence parallelism (PyTorch port).

The counterpart of ``dmlc_core_tpu/parallel/ulysses.py``, the sibling of
:mod:`~dmlc_core_tpu_torch.parallel.ring_attention`: instead of rotating
K/V blocks around a ring, ONE ``all_to_all`` re-shards the activations
from sequence-sharded to head-sharded, every rank then runs
*full-sequence* attention for its subset of heads, and a second
``all_to_all`` restores sequence sharding.

The local attention is :func:`~dmlc_core_tpu_torch.ops.attention.
local_attention` on ``[B, S, H/P, D]``: on the card the hand-written flash
kernels of ``ops/csrc/attention.cu`` (forward, dK/dV, dQ) take the head
shard, as the JAX package's Pallas flash kernel does on the TPU; on the
CPU the dense oracle.  Requires ``H % axis_size == 0``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dmlc_core_tpu_torch.parallel.collectives import all_to_all

__all__ = ["ulysses_attention"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "seq", causal: bool = False,
                      scale: Optional[float] = None,
                      local_attn: Optional[Callable] = None,
                      *, mesh) -> torch.Tensor:
    """Exact attention over sequence-sharded ``q/k/v`` ``[B, S_local, H,
    D]`` via two all-to-alls over ``axis_name`` of ``mesh``.  ``local_attn(q,
    k, v, causal, scale)`` runs the full-sequence attention of this rank's
    heads (default: ``local_attention``).  Returns ``[B, S_local, H,
    D]``."""
    P = mesh.axis_size(axis_name)
    H = q.shape[2]
    if H % P:
        raise ValueError(f"ulysses: n_heads {H} not divisible by axis {P}")
    # ONE stacked all_to_all for q/k/v (not three): same bytes, one
    # collective — this and the output's inverse are the two bursts
    qkv = torch.stack([q, k, v])                      # [3, B, S/P, H, D]
    qkv = all_to_all(qkv, axis_name, split_axis=3, concat_axis=2,
                     mesh=mesh)                       # [3, B, S, H/P, D]
    qh, kh, vh = qkv.unbind(0)
    if local_attn is None:
        from dmlc_core_tpu_torch.ops.attention import local_attention

        out = local_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        out = local_attn(qh, kh, vh, causal, scale)
    # inverse: [B, S, H/P, D] -> [B, S/P, H, D]; the received head blocks
    # concatenate in rank order = the original head order
    return all_to_all(out, axis_name, split_axis=1, concat_axis=2, mesh=mesh)
