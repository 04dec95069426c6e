"""Gradient histograms for hist-method gradient boosting (PyTorch port).

The counterpart of ``dmlc_core_tpu/ops/histogram.py``.  For every tree
node, feature and bin, accumulate Σgrad and Σhess of the rows that land
there: ``hist[2, n_nodes, F, n_bins]``, plane 0 grad, plane 1 hess, rows
with ``node_id < 0`` adding nothing.  Bins are feature-major ``[F, n]``
uint8 (the JAX main path's layout).

Two kernels, each a hand-written CUDA kernel for Hopper
(``csrc/histogram.cu``) beside a plain PyTorch version of the same
function:

* :func:`hist_kernel` / :func:`hist_plain` — the root histogram (replaces
  the Pallas ``_hist_pallas_kernel``);
* :func:`fused_round_kernel` / :func:`fused_round_plain` — one tree level:
  descend, left-child histograms, sibling subtraction (replaces the Pallas
  ``_fused_round_kernel``).

Both accumulate in int64 FIXED POINT: each row's g/h is rounded to
``rint(v · 2^k)`` with one power-of-two scale per plane
(:func:`hist_scales`, chosen so that ``n · max|q| < 2^53``), summed as
integers and converted to f32 once.  Integer sums do not depend on their
order, so the kernel's concurrent atomics, the plain version's
``index_add_`` and any device give the same bytes, run after run.  On
bf16-exact g/h every sum is exact — equal to the TPU kernel's.  On general
g/h the sum carries at most one f32 rounding plus the ~2^-30·max|g|
quantisation of each row, against ~n ulps for an f32 running sum.

:func:`build_histogram` and :func:`fused_round` are the public entry
points: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ, log_fatal

__all__ = ["build_histogram", "fused_round", "select_feature_bins",
           "hist_scales", "hist_kernel", "hist_plain", "fused_round_kernel",
           "fused_round_plain", "descend_plain", "reference_histogram",
           "leaves_built_per_round", "bins_bytes_per_round"]

#: 2^SCALE_BITS bounds n·max|q|: int64 sums never overflow and convert to
#: double exactly
SCALE_BITS = 53
_SCALE_CLAMP = 100


def leaves_built_per_round(depth: int) -> int:
    """Histogram BUILDS one depth-wise boosting round pays (sibling
    subtraction derives the rest for free): the root plus every level's
    left children — ``2^(depth-1)``."""
    return 1 if depth <= 1 else 1 << (depth - 1)


def bins_bytes_per_round(depth: int, rows: int, row_bytes: int, *,
                         fused: bool = False) -> int:
    """Bin-matrix bytes ONE depth-wise boosting round streams: the number
    of full passes over the ``[F, n]`` matrix times its size.  Unfused:
    ``2·depth − 1`` passes (root histogram, a descend plus a histogram
    pass per deeper level, the final descend); the fused round collapses
    each level's descend + histogram into one read — ``depth`` passes."""
    passes = depth if fused else 2 * depth - 1
    return max(passes, 1) * rows * row_bytes


# ---------------------------------------------------------------------------
# fixed-point scales
# ---------------------------------------------------------------------------

def _scale_exp(vmax: float, n: int) -> int:
    """k with ``n · rint(vmax · 2^k) < 2^53``: vmax < 2^e (frexp), so
    |q| ≤ 2^(e+k) and n < 2^bit_length(n)."""
    CHECK(math.isfinite(vmax), f"non-finite gradient statistic ({vmax})")
    e = math.frexp(vmax)[1]
    k = SCALE_BITS - max(n, 1).bit_length() - e
    return max(-_SCALE_CLAMP, min(_SCALE_CLAMP, k))


def hist_scales(grad: torch.Tensor, hess: torch.Tensor) -> Tuple[int, int]:
    """Fixed-point exponents ``(kg, kh)`` for one tree's histograms
    (one device sync).  Every level of the tree uses the same pair, so
    the sibling subtraction ``prev − left`` runs on sums of one scale."""
    n = grad.numel()
    if n == 0:
        return _scale_exp(0.0, 0), _scale_exp(0.0, 0)
    gmax, hmax = torch.stack([grad.abs().max(), hess.abs().max()]).tolist()
    return _scale_exp(gmax, n), _scale_exp(hmax, n)


def _quantize(v: torch.Tensor, k: int) -> torch.Tensor:
    # v · 2^k is exact in f32; round half to even, as the kernel's rint
    return torch.round(v * (2.0 ** k)).to(torch.int64)


def _dequantize(acc: torch.Tensor, k: int) -> torch.Tensor:
    # |acc| < 2^53: exact in float64, exact power-of-two scale, one rounding
    return (acc.to(torch.float64) * (2.0 ** -k)).to(torch.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _accum_plain(bins_t, node_h, grad, hess, n_nodes, n_bins, kg, kh):
    """int64 [2, n_nodes·F·n_bins] fixed-point sums over rows with
    ``node_h >= 0`` (index_add_ per feature: integer, so order-free)."""
    F, n = bins_t.shape
    valid = node_h >= 0
    qg = torch.where(valid, _quantize(grad, kg), 0)
    qh = torch.where(valid, _quantize(hess, kh), 0)
    base = torch.where(valid, node_h, 0).to(torch.int64) * (F * n_bins)
    acc = torch.zeros(2, n_nodes * F * n_bins, dtype=torch.int64,
                      device=bins_t.device)
    for f in range(F):
        idx = base + (f * n_bins) + bins_t[f].to(torch.int64)
        acc[0].index_add_(0, idx, qg)
        acc[1].index_add_(0, idx, qh)
    return acc


def hist_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
               grad: torch.Tensor, hess: torch.Tensor, n_nodes: int,
               n_bins: int, kg: int, kh: int) -> torch.Tensor:
    """Plain version of :func:`hist_kernel`: the same fixed-point sums,
    bit-identical to it on any device."""
    F = bins_t.shape[0]
    acc = _accum_plain(bins_t, node_id, grad, hess, n_nodes, n_bins, kg, kh)
    return torch.stack([_dequantize(acc[0], kg), _dequantize(acc[1], kh)]
                       ).reshape(2, n_nodes, F, n_bins)


def descend_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
                  feat: torch.Tensor, thr: torch.Tensor,
                  by_node: bool = True) -> torch.Tensor:
    """Route rows one level down: ``2·node + (bins[feat, r] > thr)`` as
    int32, rows with ``node < 0`` staying −1.  ``feat``/``thr`` are
    per-node tables (``by_node``) or per-row arrays.  The one plain
    descend of the package — the kernel's descend pass, training's final
    descend and prediction all route by it."""
    valid = node_id >= 0
    if by_node:
        key = torch.where(valid, node_id, 0).to(torch.int64)
        feat, thr = feat[key], thr[key]
    go_right = (select_feature_bins(bins_t, feat) > thr).to(torch.int32)
    return torch.where(valid, 2 * node_id + go_right, -1).to(torch.int32)


def fused_round_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
                      feat: torch.Tensor, thr: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      prev_hist: torch.Tensor, n_prev: int, n_bins: int,
                      kg: int, kh: int, by_node: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_round_kernel`: ``(new_node [n],
    hist [2, 2·n_prev, F, n_bins])``."""
    F = bins_t.shape[0]
    new_node = descend_plain(bins_t, node_id, feat, thr, by_node)
    left_ok = (new_node >= 0) & (new_node % 2 == 0)
    node_h = torch.where(left_ok, new_node >> 1, -1)
    left = hist_plain(bins_t, node_h, grad, hess, n_prev, n_bins, kg, kh)
    right = prev_hist - left
    hist = torch.stack([left, right], dim=2).reshape(2, 2 * n_prev, F, n_bins)
    return new_node, hist


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    from dmlc_core_tpu_torch.ops._build import load_library

    return load_library("histogram")


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        log_fatal(f"{what}: CUDA launch failed with cudaError {rc}")


def _check_inputs(bins_t, node_id, grad, hess, n_bins):
    CHECK(bins_t.is_cuda, "kernel inputs must be CUDA tensors")
    CHECK(bins_t.dtype == torch.uint8 and bins_t.dim() == 2
          and bins_t.is_contiguous(),
          "bins_t must be a contiguous feature-major [F, n] uint8 tensor")
    n = bins_t.shape[1]
    for name, t, dt in (("node_id", node_id, torch.int32),
                        ("grad", grad, torch.float32),
                        ("hess", hess, torch.float32)):
        CHECK(t.device == bins_t.device and t.dtype == dt
              and t.shape == (n,) and t.is_contiguous(),
              f"{name} must be a contiguous [{n}] {dt} tensor on "
              f"{bins_t.device}")
    CHECK(1 <= n_bins <= 256, f"n_bins must be in [1, 256], got {n_bins}")


def _accum_kernel(bins_t, node, grad, hess, n_nodes, n_bins, kg, kh,
                  left_only):
    F, n = bins_t.shape
    acc = torch.zeros(2, n_nodes, F, n_bins, dtype=torch.int64,
                      device=bins_t.device)
    rc = _lib().dmlc_hist_accum(
        bins_t.data_ptr(), node.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        n, F, n_nodes, n_bins, 2.0 ** kg, 2.0 ** kh, int(left_only),
        acc.data_ptr(), torch.cuda.current_stream(bins_t.device).cuda_stream)
    _check_launch(rc, "dmlc_hist_accum")
    return acc


def _epilogue_kernel(acc, prev, n_nodes, kg, kh):
    _, _, F, B = acc.shape
    rows = 2 * n_nodes if prev is not None else n_nodes
    out = torch.empty(2, rows, F, B, dtype=torch.float32, device=acc.device)
    rc = _lib().dmlc_hist_epilogue(
        acc.data_ptr(), None if prev is None else prev.data_ptr(),
        out.data_ptr(), n_nodes, F * B, 2.0 ** -kg, 2.0 ** -kh,
        torch.cuda.current_stream(acc.device).cuda_stream)
    _check_launch(rc, "dmlc_hist_epilogue")
    return out


def hist_kernel(bins_t: torch.Tensor, node_id: torch.Tensor,
                grad: torch.Tensor, hess: torch.Tensor, n_nodes: int,
                n_bins: int, kg: int, kh: int) -> torch.Tensor:
    """CUDA histogram ``[2, n_nodes, F, n_bins]`` f32 (two launches:
    fixed-point accumulation, then the dequantising epilogue).  Counts
    its calls in ``hist_kernel.launches``."""
    _check_inputs(bins_t, node_id, grad, hess, n_bins)
    acc = _accum_kernel(bins_t, node_id, grad, hess, n_nodes, n_bins, kg, kh,
                        left_only=False)
    out = _epilogue_kernel(acc, None, n_nodes, kg, kh)
    hist_kernel.launches += 1
    return out


hist_kernel.launches = 0


def fused_round_kernel(bins_t: torch.Tensor, node_id: torch.Tensor,
                       feat: torch.Tensor, thr: torch.Tensor,
                       grad: torch.Tensor, hess: torch.Tensor,
                       prev_hist: torch.Tensor, n_prev: int, n_bins: int,
                       kg: int, kh: int, by_node: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tree level: ``(new_node [n], hist [2, 2·n_prev, F, n_bins])``
    (three launches: descend, left-child accumulation, subtraction
    epilogue).  ``feat``/``thr`` are per-node tables ``[n_prev]``
    (``by_node``) or per-row arrays ``[n]``.  Counts its calls in
    ``fused_round_kernel.launches``."""
    _check_inputs(bins_t, node_id, grad, hess, n_bins)
    F, n = bins_t.shape
    m = n_prev if by_node else n
    for name, t in (("feat", feat), ("thr", thr)):
        CHECK(t.device == bins_t.device and t.dtype == torch.int32
              and t.shape == (m,) and t.is_contiguous(),
              f"{name} must be a contiguous [{m}] int32 tensor")
    CHECK(prev_hist.device == bins_t.device
          and prev_hist.dtype == torch.float32
          and prev_hist.shape == (2, n_prev, F, n_bins)
          and prev_hist.is_contiguous(),
          f"prev_hist must be a contiguous [2, {n_prev}, {F}, {n_bins}] "
          "float32 tensor")
    new_node = torch.empty(n, dtype=torch.int32, device=bins_t.device)
    rc = _lib().dmlc_descend(
        bins_t.data_ptr(), node_id.data_ptr(), feat.data_ptr(),
        thr.data_ptr(), int(by_node), n, new_node.data_ptr(),
        torch.cuda.current_stream(bins_t.device).cuda_stream)
    _check_launch(rc, "dmlc_descend")
    acc = _accum_kernel(bins_t, new_node, grad, hess, n_prev, n_bins, kg, kh,
                        left_only=True)
    hist = _epilogue_kernel(acc, prev_hist, n_prev, kg, kh)
    fused_round_kernel.launches += 1
    return new_node, hist


fused_round_kernel.launches = 0


# ---------------------------------------------------------------------------
# public entry points (device dispatch)
# ---------------------------------------------------------------------------

def build_histogram(bins_t: torch.Tensor, node_id: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor, n_nodes: int,
                    n_bins: int, *, scales: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """Return ``hist[2, n_nodes, F, n_bins]`` for the feature-major bin
    matrix ``bins_t [F, n]``.  ``scales`` are the fixed-point exponents of
    :func:`hist_scales` (computed from ``grad``/``hess`` when omitted).
    CUDA tensors run :func:`hist_kernel`, CPU tensors :func:`hist_plain`."""
    kg, kh = scales if scales is not None else hist_scales(grad, hess)
    if bins_t.is_cuda:
        return hist_kernel(bins_t, node_id, grad, hess, n_nodes, n_bins,
                           kg, kh)
    CHECK_EQ(bins_t.device.type, "cpu", "unsupported device")
    return hist_plain(bins_t, node_id, grad, hess, n_nodes, n_bins, kg, kh)


def fused_round(bins_t: torch.Tensor, node_id: torch.Tensor,
                feat_sel: torch.Tensor, thr_sel: torch.Tensor,
                grad: torch.Tensor, hess: torch.Tensor,
                prev_hist: torch.Tensor, n_prev: int, n_bins: int, *,
                score_fn: Optional[Callable] = None, by_node: bool = False,
                scales: Optional[Tuple[int, int]] = None):
    """Advance rows one level AND produce both children's histograms:
    ``(new_node [n], hist [2, 2·n_prev, F, n_bins], score_fn(hist))``
    with ``hist[:, c]`` the histogram of child ``c`` (``2p``/``2p+1``
    interleaved) — the JAX ``fused_round`` with ``layout=None``.

    ``feat_sel``/``thr_sel`` are per-row ``[n]`` as in JAX, or with
    ``by_node=True`` the per-node split tables ``[n_prev]`` (looked up
    per row inside the kernel; the training loop's form).  ``prev_hist``
    is the level above's ``[2, n_prev, F, n_bins]`` histogram, built at
    the same ``scales``."""
    kg, kh = scales if scales is not None else hist_scales(grad, hess)
    feat = feat_sel.to(torch.int32).contiguous()
    thr = thr_sel.to(torch.int32).contiguous()
    if bins_t.is_cuda:
        new_node, hist = fused_round_kernel(
            bins_t, node_id, feat, thr, grad, hess,
            prev_hist.contiguous(), n_prev, n_bins, kg, kh, by_node)
    else:
        CHECK_EQ(bins_t.device.type, "cpu", "unsupported device")
        new_node, hist = fused_round_plain(
            bins_t, node_id, feat, thr, grad, hess, prev_hist, n_prev,
            n_bins, kg, kh, by_node)
    scores = score_fn(hist) if score_fn is not None else None
    return new_node, hist, scores


def select_feature_bins(bins_t: torch.Tensor,
                        feat_sel: torch.Tensor) -> torch.Tensor:
    """``bins_t[feat_sel[r], r]`` for every row r, as int32."""
    n = bins_t.shape[1]
    return bins_t[feat_sel.to(torch.int64),
                  torch.arange(n, device=bins_t.device)].to(torch.int32)


def reference_histogram(bins, node_id, grad, hess, n_nodes, n_bins):
    """Numpy oracle for tests — row-major ``bins [n, F]``, same
    ``[2, N, F, B]`` shape as :func:`build_histogram`."""
    bins = np.asarray(bins)
    node_id = np.asarray(node_id)
    out = np.zeros((2, n_nodes, bins.shape[1], n_bins), np.float64)
    for i in range(bins.shape[0]):
        if node_id[i] < 0:
            continue
        for f in range(bins.shape[1]):
            out[0, node_id[i], f, bins[i, f]] += grad[i]
            out[1, node_id[i], f, bins[i, f]] += hess[i]
    return out.astype(np.float32)
