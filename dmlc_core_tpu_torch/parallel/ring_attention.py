"""The single-device attention oracle (PyTorch port).

The counterpart of ``dmlc_core_tpu/parallel/ring_attention.py``'s
:func:`reference_attention`: dense softmax attention in f32 over
``[B, S, H, D]``, the path ``ops.attention.local_attention`` takes for a
shape or device its kernel does not take (always, on the CPU).
``ring_attention`` itself shards the sequence over a ``seq`` mesh axis,
which the port does not have yet (ROADMAP A16).
"""

from __future__ import annotations

import torch

__all__ = ["reference_attention"]


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale=None) -> torch.Tensor:
    """Full softmax attention in f32; the output in ``q``'s dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        S = q.shape[1]
        later = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(later, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
