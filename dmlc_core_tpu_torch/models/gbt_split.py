"""Split chooser and row routing for HistGBT (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/gbt_split.py`` for the
unconstrained, NaN-free case: XGBoost hist's split evaluator over
``hist [2, N, F, B]``, run as torch ops on the histogram's device.

Given the same histogram it picks the same ``(feat, thr)`` as the JAX
package, bit for bit: the cumulative sums repeat XLA's CPU addition order
(:func:`~dmlc_core_tpu_torch.ops.quantile.xla_cumsum`), the gain is the
same sequence of f32 operations, and ``torch.argmax`` keeps
``jnp.argmax``'s first-maximum rule on ties.  Every step is an
elementwise IEEE operation or an exact reduction, so the CPU and the GPU
agree too.  Monotone constraints and the learned missing direction are
not ported yet.
"""

from __future__ import annotations

import torch

from dmlc_core_tpu_torch.ops.histogram import descend_plain
from dmlc_core_tpu_torch.ops.quantile import xla_cumsum

__all__ = ["_make_best_split", "_advance_node", "_soft_threshold",
           "_maybe_l1"]


def _soft_threshold(G, alpha: float):
    """XGBoost's ThresholdL1: shrink the gradient sum toward 0 by the
    L1 penalty before forming weights/gains."""
    return torch.sign(G) * torch.clamp(G.abs() - alpha, min=0.0)


def _maybe_l1(G, alpha: float):
    """Thresholded gradient sum when L1 is on, the raw sum when off."""
    return _soft_threshold(G, alpha) if alpha > 0.0 else G


def _make_best_split(B: int, lam: float, gamma: float, mcw: float,
                     with_child_sums: bool = False, alpha: float = 0.0):
    """Greedy per-node split chooser over a gradient histogram.

    hist [2,N,F,B] → (feat [N], thr [N], split_gain [N]); degenerate
    split (feat 0, thr B-1 → everyone left, gain 0) when ``0.5·gain ≤
    gamma``.  ``with_child_sums=True`` also returns the children's
    ``(g_sum, h_sum)`` as ``[2N]`` (left = 2i, right = 2i+1): the cumsum
    at the chosen threshold is the left child's sum, parent − left the
    right's, so the deepest level's leaf sums come from the histogram."""

    if alpha > 0.0:
        def _score(G, H):
            t = _soft_threshold(G, alpha)
            return t * t / (H + lam)
    else:
        def _score(G, H):
            return G * G / (H + lam)

    def best_split(hist):
        # both planes in one scan: [2,N,F,B] left-inclusive sums
        cg, ch = xla_cumsum(hist)
        gl = cg[..., :-1]                            # [N,F,B-1] left: bin ≤ b
        hl = ch[..., :-1]
        gt = cg[..., -1:]                            # [N,F,1]
        ht = ch[..., -1:]
        gr = gt - gl
        hr = ht - hl
        gain = (_score(gl, hl) + _score(gr, hr)) - _score(gt, ht)
        ok = (hl >= mcw) & (hr >= mcw)
        gain = torch.where(ok, gain, float("-inf"))
        flat = gain.reshape(gain.shape[0], -1)       # [N, F*(B-1)]
        best = torch.argmax(flat, dim=1)
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        feat = (best // (B - 1)).to(torch.int32)
        thr = (best % (B - 1)).to(torch.int32)
        split_ok = 0.5 * best_gain > gamma
        feat = torch.where(split_ok, feat, 0)
        thr = torch.where(split_ok, thr, B - 1)      # bins ≤ B-1 → all left
        split_gain = torch.where(split_ok, 0.5 * best_gain, 0.0)
        if not with_child_sums:
            return feat, thr, split_gain
        N, F = hist.shape[1], hist.shape[2]
        n_idx = torch.arange(N, device=hist.device)
        flat_idx = (n_idx * F + feat) * B + thr
        lg = cg.reshape(-1)[flat_idx]                # left-child sums [N]
        lh = ch.reshape(-1)[flat_idx]
        tg = cg[:, 0, -1]                            # node totals
        th_ = ch[:, 0, -1]
        child_g = torch.stack([lg, tg - lg], dim=1).reshape(2 * N)
        child_h = torch.stack([lh, th_ - lh], dim=1).reshape(2 * N)
        return feat, thr, split_gain, child_g, child_h

    return best_split


def _advance_node(bins_t, node, feat, thr, layout=None):
    """Route rows one level down the tree by the per-node tables
    ``feat``/``thr``; padding rows (node<0) stay -1.  ``bins_t`` is
    feature-major [F, n], or the physical matrix of ``layout``."""
    return descend_plain(bins_t, node, feat, thr, by_node=True,
                         layout=layout)
