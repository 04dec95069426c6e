"""Expert parallelism (Switch-style mixture-of-experts) over an ``expert``
mesh axis (PyTorch port).

The counterpart of ``dmlc_core_tpu/parallel/moe.py``: experts shard over
the axis, and tokens move to their expert and back as TWO
:func:`~dmlc_core_tpu_torch.parallel.collectives.all_to_all` collectives.
E experts over P ranks, E/P each; on one rank's tokens:

1. route: top-1 over the router's softmax in f32 (ties to the lowest
   expert index, as ``jnp.argmax`` breaks them — ``torch.argmax`` on CUDA
   does not promise which maximum it returns), the gate that expert's
   probability; per-expert positions by a cumsum over this rank's
   tokens, and tokens beyond the capacity ``C = ceil(cf · T / E)`` are
   DROPPED (output 0: the caller's residual carries them);
2. dispatch: a ``[T, E, C]`` one-hot product packs tokens into
   per-expert slots;
3. ``all_to_all`` the ``[P, E_local, C, D]`` slabs so that every rank
   holds all ranks' slots for ITS experts; the batched expert FFN (tanh
   GELU); ``all_to_all`` back; combine with gate · dispatch.

The capacity is this rank's (a shard-local cumsum), as in the JAX
package.  The auxiliary load-balancing loss (Switch eq. 4) is returned,
or with ``stats=True`` its raw sums for the caller to reduce globally.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dmlc_core_tpu_torch.parallel.collectives import all_to_all

__all__ = ["moe_ffn", "reference_moe_ffn", "top1"]


def top1(probs: torch.Tensor) -> torch.Tensor:
    """Index of each row's largest value, the lowest index on a tie."""
    E = probs.shape[-1]
    best = probs.amax(dim=-1, keepdim=True)
    idx = torch.arange(E, device=probs.device).expand_as(probs)
    return torch.where(probs == best, idx, E).amin(dim=-1)


def moe_ffn(x: torch.Tensor, wr: torch.Tensor, w1: torch.Tensor,
            b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            axis: Optional[str] = "expert", capacity_factor: float = 1.25,
            stats: bool = False, mesh=None) -> Tuple[torch.Tensor, Any]:
    """Top-1 expert FFN of ``x`` ``[T, D]`` (router ``wr`` ``[D, E]``
    replicated; ``w1 [E_local, D, F]``, ``b1 [E_local, F]``,
    ``w2 [E_local, F, D]``, ``b2 [E_local, D]`` this rank's experts);
    returns ``(y [T, D], aux_loss)``.

    ``axis`` is an axis of ``mesh``; ``axis=None`` runs the same math
    unsharded (``w1`` then holds ALL experts, and no mesh is needed).  ``stats=True`` returns ``(y, (assign_sum [E], prob_sum
    [E], T))`` instead of the scalar aux: the routing statistics' SUMS,
    which the caller psums over its token axes to form the aux loss of
    the global batch."""
    T, D = x.shape
    E = wr.shape[1]
    P = mesh.axis_size(axis) if axis is not None else 1
    e_local = w1.shape[0]
    cap = max(1, int(np.ceil(capacity_factor * T / E)))

    logits = x @ wr                                       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    expert_idx = top1(probs.detach())                     # [T]
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    onehot = F.one_hot(expert_idx, E).to(x.dtype)         # [T, E]
    # aux load-balance loss (Switch eq. 4): E · Σ_e fraction_e · prob_e
    assign_sum = onehot.sum(dim=0)                        # [E]
    prob_sum = probs.sum(dim=0)                           # [E]
    aux = E * torch.sum((assign_sum / T) * (prob_sum / T))
    pos = (torch.cumsum(onehot, dim=0) * onehot).to(torch.int64)  # 1-based
    keep = (pos > 0) & (pos <= cap)
    slot = (F.one_hot((pos - 1).clamp(0, cap - 1), cap).to(x.dtype)
            * keep[..., None].to(x.dtype))
    dispatch = onehot[..., None] * slot                   # [T, E, C]

    xe = torch.einsum("tec,td->ecd", dispatch, x)         # [E, C, D]
    if axis is not None:
        # each expert slab to its owner; every rank's tokens for the
        # local experts come back: [P, E_local, C, D]
        xe = xe.reshape(P, e_local, cap, D)
        xe = all_to_all(xe, axis, 0, 0, mesh)
        xe = xe.movedim(0, 1).reshape(e_local, P * cap, D)
    # the batched expert FFN on [E_local, slots, D]
    h = F.gelu(torch.einsum("esd,edf->esf", xe, w1) + b1[:, None, :],
               approximate="tanh")
    ye = torch.einsum("esf,efd->esd", h, w2) + b2[:, None, :]
    if axis is not None:
        ye = ye.reshape(e_local, P, cap, D).movedim(1, 0)
        ye = all_to_all(ye.contiguous(), axis, 0, 0, mesh)
        ye = ye.reshape(E, cap, D)
    y = torch.einsum("tec,ecd->td", dispatch, ye) * gate[:, None]
    if stats:
        return y, (assign_sum, prob_sum, torch.tensor(
            float(T), dtype=torch.float32, device=x.device))
    return y, aux


def reference_moe_ffn(x, wr, w1_all, b1_all, w2_all, b2_all,
                      capacity_factor=1e9):
    """Numpy oracle: per-token dense expert application (no capacity
    pressure unless ``capacity_factor`` is set low, matching
    :func:`moe_ffn`'s drop rule)."""
    x = np.asarray(x)
    T, D = x.shape
    E = np.asarray(wr).shape[1]
    cap = max(1, int(np.ceil(capacity_factor * T / E)))
    logits = x @ np.asarray(wr)
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = z / z.sum(-1, keepdims=True)
    idx = probs.argmax(-1)
    gate = probs[np.arange(T), idx]
    y = np.zeros_like(x)
    counts = np.zeros(E, np.int64)
    for t in range(T):
        e = idx[t]
        counts[e] += 1
        if counts[e] > cap:
            continue                       # dropped: residual only
        h = x[t] @ np.asarray(w1_all)[e] + np.asarray(b1_all)[e]
        h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                   * (h + 0.044715 * h ** 3)))
        y[t] = (h @ np.asarray(w2_all)[e] + np.asarray(b2_all)[e]) * gate[t]
    return y
