"""Ring attention: exact attention over sequence-sharded Q/K/V (PyTorch
port).

The counterpart of ``dmlc_core_tpu/parallel/ring_attention.py``.  The
``seq`` axis of a mesh shards tokens over ranks; full attention needs
every (query, key) pair, which the ring provides without the full
sequence on one rank:

* each rank holds local blocks ``q/k/v [B, S/P, H, D]``;
* K/V blocks rotate around ``seq`` with
  :func:`~dmlc_core_tpu_torch.parallel.collectives.ppermute` (one hop a
  step, P steps);
* the softmax is accumulated online (running max and normaliser) in f32,
  so the result is exact, not approximate.

Each block's scores are torch ops, as the JAX package's are jnp outside
any Pallas kernel.  The backward is autograd through the ``ppermute``
Function: the reverse rotations, as ``jax.grad`` through JAX's ``scan``
gives them.  The rotation after the last block feeds nothing, so it is
not made.

:func:`reference_attention` is the single-device oracle: dense softmax
in f32, the path ``ops.attention.local_attention`` takes for a shape or
device its kernel does not take (always, on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from dmlc_core_tpu_torch.parallel.collectives import ppermute

__all__ = ["ring_attention", "reference_attention"]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "seq", causal: bool = False,
                   scale: Optional[float] = None, *, mesh) -> torch.Tensor:
    """Exact attention over the ``axis_name`` axis of ``mesh``.  ``q/k/v`` are this rank's blocks
    ``[B, S_local, H, D]``; returns its output block in ``q``'s dtype.
    Causal masking uses global token positions."""
    n_dev = mesh.axis_size(axis_name)
    my_idx = mesh.axis_index(axis_name)
    B, s_local, H, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    dev = q.device
    q_pos = my_idx * s_local + torch.arange(s_local, device=dev)
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    o = torch.zeros((B, H, s_local, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, s_local), float("-inf"), device=dev)
    l = torch.zeros((B, H, s_local), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for i in range(n_dev):
        # after i rotations this rank holds the block born on (my_idx - i)
        src_idx = (my_idx - i) % n_dev
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        if causal:
            k_pos = src_idx * s_local + torch.arange(s_local, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows: exp(-inf - (-inf)) -> a finite floor
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.exp(torch.where(torch.isneginf(m), m, m - m_safe))
        p = torch.exp(s - m_safe[..., None])
        if causal:
            p = torch.where(torch.isneginf(s), 0.0, p)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
        m = m_new
        if i + 1 < n_dev:
            k_blk = ppermute(k_blk, axis_name, perm, mesh)
            v_blk = ppermute(v_blk, axis_name, perm, mesh)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


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
