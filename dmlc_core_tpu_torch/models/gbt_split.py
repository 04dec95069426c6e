"""Split chooser and row routing for HistGBT (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/gbt_split.py``: XGBoost hist's
split evaluator over ``hist [2, N, F, B]``, run as torch ops on the
histogram's device.

Given the same histogram it picks the same ``(feat, thr)`` as the JAX
package, bit for bit: the cumulative sums repeat XLA's CPU addition order
(:func:`~dmlc_core_tpu_torch.ops.quantile.xla_cumsum`), the gain is the
same sequence of f32 operations, and ``torch.argmax`` keeps
``jnp.argmax``'s first-maximum rule on ties.  Every step is an
elementwise IEEE operation or an exact reduction, so the CPU and the GPU
agree too.  With ``missing=True`` it also learns each node's default
direction for NaN rows, with ``mono`` it scores monotone-constrained
splits at their bound-clipped weights, and a ``feat_mask`` (column
sampling) takes features out of the choice, as the JAX package does.

Also the host binning route (``DMLC_TPU_BIN_BACKEND=cpu``:
:func:`_host_bin_t`) and the boosting loop's metrics (:func:`gbt_metrics`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal
from dmlc_core_tpu_torch.base.parameter import get_env
from dmlc_core_tpu_torch.ops.histogram import descend_kernel, descend_plain
from dmlc_core_tpu_torch.ops.quantile import xla_cumsum

__all__ = ["_make_best_split", "_advance_node", "_soft_threshold",
           "_maybe_l1", "_host_bin_requested", "_host_bin_t", "gbt_metrics"]


def gbt_metrics():
    """The boosting loop's instruments on the process registry, under the
    JAX package's names: ``gbt_rounds_total`` and ``gbt_trees_total``
    (counters) and ``gbt_phase_seconds`` (histogram), each labelled by
    ``engine`` (``phase`` too for the last)."""
    r = _metrics.default_registry()
    return {
        "rounds": r.counter("gbt_rounds_total", "boosting rounds completed",
                            labels=("engine",)),
        "trees": r.counter("gbt_trees_total", "trees fetched to host",
                           labels=("engine",)),
        "phase": r.histogram(
            "gbt_phase_seconds",
            "per-phase wall time: round (boost, per round from the chunk "
            "fetches), warmup (kernel build join + discarded rounds)",
            labels=("engine", "phase")),
    }


def _host_bin_requested() -> bool:
    """True when ``DMLC_TPU_BIN_BACKEND=cpu`` asks for host-side numpy
    binning (unset or empty: bin on the data's device).  Any other value
    is fatal, as in the JAX package: routing a typo to the host loop
    would invert the operator's intent.  The host route uploads the
    uint8 bin matrix, a quarter of the f32 features' bytes."""
    backend = get_env("DMLC_TPU_BIN_BACKEND", "", str)
    if backend in ("", "cpu"):
        return backend == "cpu"
    log_fatal(f"DMLC_TPU_BIN_BACKEND={backend!r}: only 'cpu' (host numpy "
              f"binning) or unset (bin on the data's device) are valid")


def _host_bin_t(X: np.ndarray, cuts_np: np.ndarray,
                missing: bool = False) -> np.ndarray:
    """Bin ``X`` on the HOST and return the FEATURE-major bin matrix.

    Numpy searchsorted, feature by feature — the semantics of
    :func:`~dmlc_core_tpu_torch.ops.quantile.apply_bins` (bin = #cuts ≤
    value, side='right'; uint8 when the bins fit; ``missing=True`` sends
    NaN to the reserved top bin), without a second full-matrix copy."""
    miss_bin = cuts_np.shape[1] + 1
    n_max = miss_bin if missing else cuts_np.shape[1]
    dtype = np.uint8 if n_max < 256 else np.int32
    out = np.empty((X.shape[1], len(X)), dtype)
    for j in range(X.shape[1]):
        col = np.searchsorted(cuts_np[j], X[:, j],
                              side="right").astype(dtype)
        if missing:
            col[np.isnan(X[:, j])] = miss_bin
        out[j] = col
    return out


def _soft_threshold(G, alpha: float):
    """XGBoost's ThresholdL1: shrink the gradient sum toward 0 by the
    L1 penalty before forming weights/gains."""
    return torch.sign(G) * torch.clamp(G.abs() - alpha, min=0.0)


def _maybe_l1(G, alpha: float):
    """Thresholded gradient sum when L1 is on, the raw sum when off."""
    return _soft_threshold(G, alpha) if alpha > 0.0 else G


def _make_best_split(B: int, lam: float, gamma: float, mcw: float,
                     with_child_sums: bool = False, alpha: float = 0.0,
                     missing: bool = False,
                     mono: Optional[np.ndarray] = None):
    """Greedy per-node split chooser over a gradient histogram.

    hist [2,N,F,B] → (feat [N], thr [N], split_gain [N]); degenerate
    split (feat 0, thr B-1 → everyone left, gain 0) when ``0.5·gain ≤
    gamma``.  ``with_child_sums=True`` also returns the children's
    ``(g_sum, h_sum)`` as ``[2N]`` (left = 2i, right = 2i+1): the cumsum
    at the chosen threshold is the left child's sum, parent − left the
    right's, so the deepest level's leaf sums come from the histogram.

    ``missing=True`` (XGBoost's learned default direction): bin ``B-1``
    holds the NaN rows, value bins are ``0..B-2``.  Every candidate is
    scored with the node's missing mass on the right (the plain formula:
    value cumsums leave bin B-1 out, totals hold it) and on the left,
    ``min_child_weight`` checked per direction; the better direction is
    each node's ``dir`` (1 = missing left), returned between thr and
    gain, and the left child's sums take the missing mass where it goes
    left.  A degenerate node keeps thr = B-1, dir = 1: every row left.

    ``mono`` ([F] ints in {-1, 0, +1}; not with ``missing``) enables
    monotone constraints: gains are XGBoost's constrained gains at the
    child and parent weights clipped into each node's inherited
    ``bounds`` [N, 2], and a candidate on a constrained feature whose
    child weights break the ordering scores −inf.  The caller propagates
    the bounds level to level and clips the leaves.

    The chooser is ``best_split(hist, feat_mask=None, bounds=None)``;
    ``feat_mask`` [F] bool (column sampling) scores the features it
    leaves out −inf."""
    CHECK(mono is None or not missing,
          "monotone constraints are not supported with missing=True "
          "(the constrained-gain branch has no missing-direction form)")
    mono_t = None if mono is None else torch.as_tensor(
        np.asarray(mono, np.int32))

    if alpha > 0.0:
        def _score(G, H):
            t = _soft_threshold(G, alpha)
            return t * t / (H + lam)
    else:
        def _score(G, H):
            return G * G / (H + lam)

    def side_gain(gl, hl, gt, ht):
        gr = gt - gl
        hr = ht - hl
        gain = (_score(gl, hl) + _score(gr, hr)) - _score(gt, ht)
        ok = (hl >= mcw) & (hr >= mcw)
        return torch.where(ok, gain, float("-inf"))

    def objv(G, H, w):
        return G * w + 0.5 * (H + lam) * w * w

    def mono_gain(gl, hl, gt, ht, bounds):
        """The constrained gain at the clipped weights (the closed form
        at bounds ±inf), −inf where the ordering breaks or a child is
        under ``min_child_weight``."""
        gr = gt - gl
        hr = ht - hl
        wl = -gl / (hl + lam)                        # candidate child weights
        wr = -gr / (hr + lam)
        wp = -gt / (ht + lam)
        if bounds is not None:                       # inherited node bounds
            lo = bounds[:, 0][:, None, None]
            hi = bounds[:, 1][:, None, None]
            wl = torch.minimum(torch.maximum(wl, lo), hi)
            wr = torch.minimum(torch.maximum(wr, lo), hi)
            wp = torch.minimum(torch.maximum(wp, lo), hi)
        gain = 2.0 * (objv(gt, ht, wp) - objv(gl, hl, wl)
                      - objv(gr, hr, wr))
        m = mono_t.to(gl.device)[None, :, None]      # [1, F, 1]
        viol = ((m > 0) & (wl > wr)) | ((m < 0) & (wl < wr))
        gain = torch.where(viol, float("-inf"), gain)
        ok = (hl >= mcw) & (hr >= mcw)
        return torch.where(ok, gain, float("-inf"))

    def best_split(hist, feat_mask=None, bounds=None):
        # both planes in one scan: [2,N,F,B] left-inclusive sums
        cg, ch = xla_cumsum(hist)
        gl = cg[..., :-1]                            # [N,F,B-1] left: bin ≤ b
        hl = ch[..., :-1]
        gt = cg[..., -1:]                            # [N,F,1]
        ht = ch[..., -1:]
        if missing:
            miss_g = hist[0, ..., B - 1]             # [N,F] NaN-bin mass
            miss_h = hist[1, ..., B - 1]
            gain_r = side_gain(gl, hl, gt, ht)       # missing → right
            gain_l = side_gain(gl + miss_g[..., None],
                               hl + miss_h[..., None], gt, ht)
            gain = torch.maximum(gain_r, gain_l)
            dir_l = gain_l > gain_r                  # [N,F,B-1]
        elif mono_t is not None:
            gain = mono_gain(gl, hl, gt, ht, bounds)
        else:
            gain = side_gain(gl, hl, gt, ht)
        if feat_mask is not None:                    # colsample: [F] bool
            gain = torch.where(feat_mask[None, :, None], gain,
                               float("-inf"))
        flat = gain.reshape(gain.shape[0], -1)       # [N, F*(B-1)]
        best = torch.argmax(flat, dim=1)
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        feat = (best // (B - 1)).to(torch.int32)
        thr = (best % (B - 1)).to(torch.int32)
        split_ok = 0.5 * best_gain > gamma
        feat = torch.where(split_ok, feat, 0)
        thr = torch.where(split_ok, thr, B - 1)      # bins ≤ B-1 → all left
        split_gain = torch.where(split_ok, 0.5 * best_gain, 0.0)
        head = (feat, thr)
        if missing:
            dirv = torch.gather(dir_l.reshape(dir_l.shape[0], -1), 1,
                                best[:, None])[:, 0].to(torch.int32)
            dirv = torch.where(split_ok, dirv, 1)    # degenerate: all left
            head = (feat, thr, dirv)
        if not with_child_sums:
            return head + (split_gain,)
        N, F = hist.shape[1], hist.shape[2]
        n_idx = torch.arange(N, device=hist.device)
        flat_idx = (n_idx * F + feat) * B + thr
        lg = cg.reshape(-1)[flat_idx]                # left-child sums [N]
        lh = ch.reshape(-1)[flat_idx]
        if missing:
            # a degenerate thr = B-1 holds the missing bin in its cumsum
            add_miss = (dirv == 1) & (thr < B - 1)
            mg = miss_g.reshape(-1)[n_idx * F + feat]
            mh = miss_h.reshape(-1)[n_idx * F + feat]
            lg = lg + torch.where(add_miss, mg, 0.0)
            lh = lh + torch.where(add_miss, mh, 0.0)
        tg = cg[:, 0, -1]                            # node totals
        th_ = ch[:, 0, -1]
        child_g = torch.stack([lg, tg - lg], dim=1).reshape(2 * N)
        child_h = torch.stack([lh, th_ - lh], dim=1).reshape(2 * N)
        return head + (split_gain, child_g, child_h)

    return best_split


def _advance_node(bins_t, node, feat, thr, layout=None, dir_sel=None,
                  miss_bin=None):
    """Route rows one level down the tree by the per-node tables
    ``feat``/``thr`` (and ``dir_sel``, the learned missing direction of
    rows in ``miss_bin``); padding rows (node<0) stay -1.  ``bins_t`` is
    feature-major [F, n], or the physical matrix of ``layout``.  CUDA
    tensors launch :func:`~dmlc_core_tpu_torch.ops.histogram.
    descend_kernel`, CPU tensors run its plain version."""
    if bins_t.is_cuda:
        return descend_kernel(bins_t, node, feat.to(torch.int32).contiguous(),
                              thr.to(torch.int32).contiguous(), True, layout,
                              None if dir_sel is None
                              else dir_sel.to(torch.int32).contiguous(),
                              miss_bin)
    return descend_plain(bins_t, node, feat, thr, by_node=True,
                         layout=layout, dir_sel=dir_sel, miss_bin=miss_bin)

