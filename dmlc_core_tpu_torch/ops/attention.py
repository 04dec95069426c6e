"""Local (single-device) attention with a hand-written flash kernel.

The counterpart of ``dmlc_core_tpu/ops/attention.py``.
:func:`local_attention` keeps the ``[B, S, H, D]`` convention and
dispatches:

* a CUDA bf16 tensor whose head dim the kernels take
  (:func:`flash_eligible`) → :class:`FlashAttention`, the hand-written
  CUDA flash attention of ``csrc/attention.cu``: online softmax, the
  scores never stored in device memory, with hand-written backward
  kernels;
* anything else → the dense f32 oracle
  (:func:`~dmlc_core_tpu_torch.parallel.ring_attention.reference_attention`),
  as the JAX package's dense path takes the shapes its kernel refuses.

The JAX package calls the library kernel
``jax.experimental.pallas.ops.tpu.flash_attention``, whose ``custom_vjp``
holds three ``pallas_call``\\ s.  Each has a CUDA kernel here beside a
plain PyTorch version of the same function (f32 torch ops returning what
the kernel returns):

* :func:`flash_fwd_kernel` / :func:`flash_fwd_plain` — ``o`` and the
  softmax residual ``lse = m + log l`` (f32 ``[B, H, S]``; the library
  keeps ``l`` and ``m`` apart);
* :func:`flash_bwd_dkv_kernel` / :func:`flash_bwd_dkv_plain` — dK, dV;
* :func:`flash_bwd_dq_kernel` / :func:`flash_bwd_dq_plain` — dQ.

``di = rowsum(o · dO)`` is one torch op between them, as the library
computes it in XLA outside its kernels.  :class:`FlashAttention` runs the
kernels on CUDA tensors and the plain versions on CPU tensors; a kernel
wrapper given anything else raises, and nothing falls back from one to
the other.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal
from dmlc_core_tpu_torch.parallel.ring_attention import reference_attention

__all__ = ["local_attention", "flash_eligible", "FlashAttention",
           "flash_fwd_kernel", "flash_fwd_plain", "flash_bwd_dkv_kernel",
           "flash_bwd_dkv_plain", "flash_bwd_dq_kernel", "flash_bwd_dq_plain",
           "MASK_VALUE"]

#: the library's finite mask for causal scores (``DEFAULT_MASK_VALUE``)
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
#: head dims the CUDA kernels are instantiated for
_HEAD_DIMS = range(64, 129, 16)


def flash_eligible(q: torch.Tensor) -> bool:
    """True when the CUDA kernels take ``q`` ``[B, S, H, D]``: a CUDA bf16
    tensor with a head dim of 64..128 in steps of 16.  Any sequence
    length is taken (tail tiles are masked)."""
    return (q.is_cuda and q.dtype == torch.bfloat16 and q.dim() == 4
            and q.shape[-1] in _HEAD_DIMS)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention on one device over ``[B, S, H, D]``, through the
    flash kernels when :func:`flash_eligible`."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if flash_eligible(q):
        return FlashAttention.apply(q, k, v, causal, scale)
    return reference_attention(q, k, v, causal=causal, scale=scale)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward: the forward kernel saves
    ``o`` and ``lse``; the backward runs the dK/dV kernel, then the dQ
    kernel.  On CPU tensors the plain versions run instead."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        fwd = flash_fwd_kernel if q.is_cuda else flash_fwd_plain
        o, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        if q.is_cuda:
            dkv, dq_fn = flash_bwd_dkv_kernel, flash_bwd_dq_kernel
        else:
            dkv, dq_fn = flash_bwd_dkv_plain, flash_bwd_dq_plain
        dk, dv = dkv(q, k, v, do, lse, di, ctx.causal, ctx.scale)
        dq = dq_fn(q, k, v, do, lse, di, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# plain versions (f32 torch ops; what the kernels return)
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    """``scale · q kᵀ`` f32 ``[B, H, Sq, Sk]`` with the causal mask's
    finite value, and the mask (None without ``causal``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    S = q.shape[1]
    later = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    return s.masked_fill(later, MASK_VALUE), later


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, S, H, D] in q's dtype, lse f32 [B, H, S])``."""
    s, later = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if later is not None:
        p = p.masked_fill(later, 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, di, causal, scale):
    """``P = exp(s − lse)`` and ``dS = P ∘ (dO vᵀ − di)``, f32
    ``[B, H, Sq, Sk]``."""
    s, later = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    if later is not None:
        p = p.masked_fill(later, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - di[..., None])


def flash_bwd_dkv_plain(q, k, v, do, lse, di, causal: bool, scale: float):
    """``(dk, dv)`` ``[B, S, H, D]`` in k's and v's dtype from the saved
    ``lse`` and ``di`` (f32 ``[B, H, S]``)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, di, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, di, causal: bool,
                       scale: float) -> torch.Tensor:
    """``dq`` ``[B, S, H, D]`` in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, di, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    return dq.to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    from dmlc_core_tpu_torch.ops._build import load_library

    return load_library("attention")


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        log_fatal(f"{what}: CUDA launch failed with cudaError {rc}")


def _check_bshd(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A bf16 ``[B, S, H, D]`` CUDA tensor shaped as ``like`` that the
    kernels read through strides: the last dim contiguous, 16-byte rows."""
    CHECK(t.is_cuda, f"{name}: kernel inputs must be CUDA tensors")
    CHECK(t.device == like.device and t.dtype == torch.bfloat16
          and t.shape == like.shape,
          f"{name} must be a bf16 {tuple(like.shape)} tensor on "
          f"{like.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    CHECK(t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
          and t.data_ptr() % 16 == 0,
          f"{name}: the last dim must be contiguous and the other strides "
          f"multiples of 8 elements on a 16-byte boundary, got strides "
          f"{t.stride()}")


def _check_qkv(q, k, v) -> None:
    CHECK(q.dim() == 4, f"q must be [B, S, H, D], got {tuple(q.shape)}")
    CHECK(q.shape[-1] in _HEAD_DIMS,
          f"head dim {q.shape[-1]}: the kernels take 64..128 in steps of 16")
    CHECK(q.shape[1] >= 1, "empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bshd(name, t, q)


def _check_bwd(q, k, v, do, lse, di) -> None:
    _check_qkv(q, k, v)
    _check_bshd("do", do, q)
    B, S, H, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        CHECK(t.device == q.device and t.dtype == torch.float32
              and t.shape == (B, H, S) and t.is_contiguous(),
              f"{name} must be a contiguous f32 [{B}, {H}, {S}] tensor on "
              f"{q.device}")


def _strides(t: torch.Tensor):
    return t.stride()[:3]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA forward: ``(o bf16 [B, S, H, D] contiguous, lse f32
    [B, H, S])``.  Counts its launches in ``flash_fwd_kernel.launches``."""
    _check_qkv(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().dmlc_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, H, D, *_strides(q), *_strides(k),
            *_strides(v), *_strides(o), float(scale), int(causal),
            _stream(q))
    _check_launch(rc, "dmlc_flash_fwd")
    flash_fwd_kernel.launches += 1
    return o, lse


flash_fwd_kernel.launches = 0


def flash_bwd_dkv_kernel(q, k, v, do, lse, di, causal: bool, scale: float):
    """CUDA dK/dV: ``(dk, dv)`` bf16 ``[B, S, H, D]`` contiguous.  Counts
    its launches in ``flash_bwd_dkv_kernel.launches``."""
    _check_bwd(q, k, v, do, lse, di)
    B, S, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        rc = _lib().dmlc_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, D, *_strides(q), *_strides(k), *_strides(v),
            *_strides(do), *_strides(dk), *_strides(dv), float(scale),
            int(causal), _stream(q))
    _check_launch(rc, "dmlc_flash_bwd_dkv")
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


flash_bwd_dkv_kernel.launches = 0


def flash_bwd_dq_kernel(q, k, v, do, lse, di, causal: bool,
                        scale: float) -> torch.Tensor:
    """CUDA dQ: ``dq`` bf16 ``[B, S, H, D]`` contiguous.  Counts its
    launches in ``flash_bwd_dq_kernel.launches``."""
    _check_bwd(q, k, v, do, lse, di)
    B, S, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        rc = _lib().dmlc_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, S, H, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            *_strides(dq), float(scale), int(causal), _stream(q))
    _check_launch(rc, "dmlc_flash_bwd_dq")
    flash_bwd_dq_kernel.launches += 1
    return dq


flash_bwd_dq_kernel.launches = 0
