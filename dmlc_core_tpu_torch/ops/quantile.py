"""Weighted quantile cuts and binning (PyTorch port).

The counterpart of ``dmlc_core_tpu/ops/quantile.py``: each worker
summarises every feature with ``n_summary`` (weighted) quantiles on an
even probability grid, summaries are merged, and the merged points are
re-quantiled into ``n_bins-1`` interior cuts, made strictly increasing.
Bin of a value = number of cuts ≤ value.

The cuts are BIT-EQUAL to the JAX package's.  To get there this module
repeats the float32 arithmetic of ``jnp.quantile`` / ``jnp.nanquantile``
(linear interpolation: ``q·(n−1)``, floor/ceil, ``lo·(1−w) + hi·w``) and of
``jnp.linspace``'s f32 grid, and :func:`xla_cumsum` repeats the addition
order XLA's CPU backend uses for ``jnp.cumsum`` (blocks of 16 summed in
sequence, block totals scanned recursively).  Every step is an elementwise
IEEE operation, so the result is the same on the CPU and on a GPU.

``torch.quantile`` is not used: it refuses inputs over 16M elements, and
a 10M × 28 matrix is 280M.  Columns are sorted one feature at a time and
interpolated by hand.

:class:`SketchAccumulator` is the streaming, bounded-memory form for data
that arrives in pages (``HistGBT.fit_external``): per-page summaries merge
up a C-ary ladder by :func:`_weighted_collapse`, with the JAX package's
stable sort, midpoint rule and ``linspace`` grid, so its cuts too are
bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["local_summary", "merge_summaries", "compute_cuts", "apply_bins",
           "apply_bins_missing", "xla_cumsum", "SketchAccumulator"]

#: XLA's CPU ReduceWindowRewriter block length for cumulative sums
_SCAN_BASE = 16


def _seq_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along the last dim, left to right, starting
    from an init value of 0 (``0 + x0`` — XLA's reduce-window loop)."""
    acc = torch.zeros_like(x[..., 0])
    sums = []
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        sums.append(acc)
    return torch.stack(sums, dim=-1)


def _exclusive(t: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(t[..., :1])
    incl = _seq_scan(t) if t.shape[-1] <= _SCAN_BASE else xla_cumsum(t)
    return torch.cat([zero, incl[..., :-1]], dim=-1)


def xla_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.cumsum`` as XLA's CPU backend computes it, bit for bit.

    XLA rewrites a cumulative sum longer than 16 into: pad to a multiple
    of 16, an in-order running sum inside each block of 16, an exclusive
    scan of the block totals (recursively, the same way), and one add of
    each block's offset.  Float addition is not associative, so the order
    decides the last bits; this repeats it with elementwise ops, giving
    the same bytes on any device."""
    if dim not in (-1, x.dim() - 1):
        return xla_cumsum(x.movedim(dim, -1)).movedim(-1, dim)
    L = x.shape[-1]
    if L <= _SCAN_BASE:
        return _seq_scan(x)
    P = -(-L // _SCAN_BASE) * _SCAN_BASE
    xp = torch.nn.functional.pad(x, (0, P - L))
    inner = _seq_scan(xp.reshape(*x.shape[:-1], P // _SCAN_BASE, _SCAN_BASE))
    offset = _exclusive(inner[..., -1])
    out = inner + offset[..., None]
    return out.reshape(*x.shape[:-1], P)[..., :L]


def _linspace01(num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, num)`` in f32 as XLA computes it: ``iota ·
    f32(1/(num−1))`` (XLA turns the division by a constant into a product
    with its reciprocal) and an exact 1.0 endpoint."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / float(div)
    step = (torch.arange(div, dtype=torch.float32, device=device)
            * recip.to(device))
    return torch.cat([step, torch.ones(1, dtype=torch.float32,
                                       device=device)])


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``a·b + c`` — the fused multiply-add XLA's CPU
    backend contracts ``a·b + c`` into.  The f64 product of two f32 is
    exact; the f64 sum rounds once, and rounding that to f32 is right
    unless it landed exactly on an f32 halfway point, where the sum's
    exact error (TwoSum) decides the direction.  (Subnormal f32 results
    are not handled; cut points never are.)"""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    low29 = s.view(torch.int64) & ((1 << 29) - 1)
    tie = (low29 == (1 << 28)) & (err != 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).double()
    return torch.where(tie, torch.nextafter(s, toward), s).float()


def _interp_sorted(a_sorted: torch.Tensor, q: torch.Tensor,
                   counts: torch.Tensor, fma_low: bool) -> torch.Tensor:
    """Linear-interpolation quantiles of each row of ``a_sorted`` [R, n]
    (valid entries first) at ``q`` [Q]; ``counts`` [R] f32 valid entries
    per row.  The f32 arithmetic of ``jnp.quantile``: returns [Q, R].

    XLA contracts the final ``lo·(1−w) + hi·w`` into one FMA, and which
    product it keeps inside the FMA depends on the surrounding program:
    ``fma(lo, 1−w, hi·w)`` in ``merge_summaries`` (``fma_low``),
    ``fma(hi, w, lo·(1−w))`` in ``local_summary``."""
    pos = q[:, None] * (counts[None, :] - 1.0)              # [Q, R]
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    top = counts[None, :] - 1.0
    low = torch.clamp(torch.minimum(low, top), min=0.0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, top), min=0.0).to(torch.int64)
    lv = torch.gather(a_sorted, 1, low.T).T
    hv = torch.gather(a_sorted, 1, high.T).T
    if fma_low:
        return _fma32(lv, lw, hv * hw)
    return _fma32(hv, hw, lv * lw)


def _interp(xq: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(xq, xp, fp)`` row-wise: ``xp``/``fp`` [R, m],
    ``xq`` [Q] → [R, Q], with JAX's f32 arithmetic (``fp[i−1] + t·df``
    contracted to one FMA) and end clamping."""
    R, m = xp.shape
    i = torch.searchsorted(xp.contiguous(),
                           xq[None, :].expand(R, -1).contiguous(),
                           right=True).clamp(1, m - 1)
    fi = torch.gather(fp, 1, i)
    fi1 = torch.gather(fp, 1, i - 1)
    xi = torch.gather(xp, 1, i)
    xi1 = torch.gather(xp, 1, i - 1)
    df = fi - fi1
    dx = xi - xi1
    delta = xq[None, :] - xi1
    eps = 2.0 ** -46          # np.spacing(np.finfo(np.float32).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fi1,
                    _fma32(delta / torch.where(dx0, 1.0, dx), df, fi1))
    f = torch.where(xq[None, :] < xp[:, :1], fp[:, :1], f)
    return torch.where(xq[None, :] > xp[:, -1:], fp[:, -1:], f)


def local_summary(x: torch.Tensor, weight: Optional[torch.Tensor],
                  n_summary: int, missing: bool = False) -> torch.Tensor:
    """Fixed-size (weighted) quantile summary of local rows: ``x`` [n, F]
    f32, ``weight`` [n] or None → [F, n_summary].  Unweighted: the
    ``jnp.quantile`` grid.  Weighted: midpoint-rule probabilities
    ``(cumsum(w) − w/2) / Σw`` interpolated onto the grid.  One feature
    is sorted at a time, so the transient is one column.

    ``missing=True`` (NaN = missing): each NaN becomes the feature's
    largest finite value with weight 0, a knot that moves no quantile,
    and the midpoint rule runs with or without ``weight``; a feature with
    no finite value here gives a NaN sentinel row, which
    :func:`merge_summaries` leaves out."""
    n, F = x.shape
    qs = _linspace01(n_summary, x.device)
    out = torch.empty(F, n_summary, dtype=torch.float32, device=x.device)
    counts = torch.full((1,), float(n), dtype=torch.float32, device=x.device)
    for f in range(F):
        col = x[:, f].contiguous()
        w = weight
        if missing:
            nan = torch.isnan(col)
            w = torch.ones_like(col) if weight is None else weight
            w = torch.where(nan, 0.0, w)
            fmax = torch.where(nan, float("-inf"), col).max()
            col = torch.where(nan, fmax, col)
        elif weight is None:
            xs = torch.sort(col).values
            if bool(torch.isnan(xs[-1:]).any()):
                # a NaN anywhere makes jnp.quantile return NaN
                xs = torch.full_like(xs, float("nan"))
            out[f] = _interp_sorted(xs[None, :], qs, counts, False)[:, 0]
            continue
        xs, order = torch.sort(col, stable=True)
        ws = w[order]
        cw = xla_cumsum(ws)
        total = cw[-1:]
        probs = (cw - 0.5 * ws) / total
        out[f] = _interp(qs, probs[None, :], xs[None, :])[0]
        if missing:
            # all-NaN here: the 0/0 probabilities become the sentinel row
            out[f] = torch.where(total <= 0.0, float("nan"), out[f])
    return out


def merge_summaries(gathered: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Merge ``[W, F, n_summary]`` summaries into ``[F, n_bins-1]`` cuts:
    ``nanquantile`` re-quantiling, a finite ramp for all-NaN rows, then
    the strictly-increasing guard ``s_i = max(c_i, s_{i−1} + eps_{i−1})``
    computed as ``E + cummax(c − E)`` with ``E`` the exclusive prefix sum
    of ``eps = max(|c|·1e-6, 1e-6)``."""
    W, F, S = gathered.shape
    merged = gathered.permute(1, 0, 2).reshape(F, W * S)
    qs = _linspace01(n_bins + 1, merged.device)[1:-1]
    # NaNs sort last; quantiles index only the finite prefix
    srt = torch.sort(merged, dim=1).values
    counts = (~torch.isnan(merged)).sum(dim=1).to(torch.float32)
    cuts = _interp_sorted(srt, qs, counts, True).T                 # [F, n_bins-1]
    ramp = torch.arange(n_bins - 1, dtype=cuts.dtype, device=cuts.device)
    cuts = torch.where(torch.isnan(cuts), ramp[None, :], cuts)
    eps = torch.clamp(cuts.abs() * 1e-6, min=1e-6)
    E = xla_cumsum(eps) - eps
    return E + torch.cummax(cuts - E, dim=1).values


def compute_cuts(x: torch.Tensor, n_bins: int = 256,
                 weight: Optional[torch.Tensor] = None,
                 n_summary: Optional[int] = None,
                 allgather_fn: Optional[Callable] = None,
                 missing: bool = False) -> torch.Tensor:
    """End-to-end cuts ``[F, n_bins-1]`` f32 on ``x``'s device.

    ``allgather_fn(summary) -> [W, F, S]`` (numpy in, numpy out, e.g.
    ``parallel.collectives.allgather``) merges the summaries of W
    workers, each over its own rows, as the JAX package's merge does;
    None means one worker.  ``missing=True``: cuts over the finite values
    only (NaN = missing, :func:`local_summary`); the caller reserves a
    bin for NaN (:func:`apply_bins_missing`)."""
    CHECK(n_bins >= 2, "need at least 2 bins")
    n_summary = n_summary or max(8 * n_bins, 64)
    summary = local_summary(x, weight, n_summary, missing)
    if allgather_fn is None:
        return merge_summaries(summary[None], n_bins)
    gathered = np.asarray(allgather_fn(summary.cpu().numpy()), np.float32)
    return merge_summaries(torch.from_numpy(gathered).to(x.device), n_bins)


def _weighted_collapse(stack: torch.Tensor, wts: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """Merge ``[K, F, S]`` summaries with per-summary weights ``[K]`` into
    one ``[F, n_out]`` summary: each point carries ``w_k / S`` mass, the
    merged multiset is re-quantiled on an even grid (stable sort,
    midpoint-rule probabilities, ``jnp.interp``) — the JAX package's
    fixed-shape merge, in its f32 arithmetic."""
    K, F, S = stack.shape
    pts = stack.permute(1, 0, 2).reshape(F, K * S)                    # [F, K·S]
    w = (wts / float(S))[:, None].expand(K, S).reshape(K * S)
    order = torch.argsort(pts, dim=1, stable=True)
    xs = torch.gather(pts, 1, order)
    ws = torch.gather(w[None, :].expand(F, K * S), 1, order)
    cw = xla_cumsum(ws)
    total = cw[:, -1:]
    probs = (cw - 0.5 * ws) / total                                   # midpoint rule
    return _interp(_linspace01(n_out, stack.device), probs, xs)       # [F, n_out]


class SketchAccumulator:
    """Streaming quantile sketch with bounded memory — the JAX package's
    ``SketchAccumulator`` (the out-of-core sketch pass of
    ``HistGBT.fit_external``).

    Each page of rows contributes a fixed-size weighted summary
    (:func:`local_summary`, on ``device``); summaries merge up a
    **C-ary ladder** (C = ``buffer_pages``): whenever a level holds C
    summaries they collapse (:func:`_weighted_collapse`) into one at the
    next level, so any value passes at most ``⌈log_C P⌉`` merge stages and
    host memory stays ``O(C · log_C P · F · n_summary)``.  Summaries are
    kept on the host as numpy arrays, the page weights as the JAX
    package's numpy sums.  ``finalize`` optionally merges across workers
    through an allgather.  The cuts are bit-equal to the JAX package's on
    any device."""

    def __init__(self, n_features: int, n_summary: int = 2048,
                 buffer_pages: int = 32, device=None):
        from dmlc_core_tpu_torch.utils.device import resolve_device

        CHECK(buffer_pages >= 2, "need at least 2 buffered summaries")
        self._F = n_features
        self._S = n_summary
        self._cap = buffer_pages
        self._device = resolve_device(device)
        # merge ladder: _levels[ℓ] = list of ([F, S] summary, weight)
        self._levels: list = [[]]
        self.pages_seen = 0

    def add(self, x: np.ndarray, weight: Optional[np.ndarray] = None) -> None:
        """Absorb a page of rows ``[n, F]`` (``weight``: [n] or None)."""
        x = np.asarray(x, np.float32)
        CHECK(x.shape[1] == self._F, "feature-count mismatch")
        if x.shape[0] == 0:
            return
        w = (None if weight is None else torch.from_numpy(
            np.ascontiguousarray(weight, np.float32)).to(self._device))
        s = local_summary(torch.from_numpy(x).to(self._device), w,
                          self._S).cpu().numpy()
        wt = float(x.shape[0] if weight is None else np.sum(weight))
        self.pages_seen += 1
        self._levels[0].append((s, wt))
        lvl = 0
        while len(self._levels[lvl]) >= self._cap:   # carry up the ladder
            merged = self._merge_group(self._levels[lvl])
            self._levels[lvl] = []
            if lvl + 1 == len(self._levels):
                self._levels.append([])
            self._levels[lvl + 1].append(merged)
            lvl += 1

    def _collapse(self, stack: np.ndarray, wts: np.ndarray) -> torch.Tensor:
        return _weighted_collapse(torch.from_numpy(stack).to(self._device),
                                  torch.from_numpy(wts).to(self._device),
                                  self._S)

    def _merge_group(self, group: list) -> tuple:
        wts = np.asarray([w for _, w in group], np.float32)
        merged = self._collapse(np.stack([s for s, _ in group]), wts)
        return merged.cpu().numpy(), float(wts.sum())

    def summary(self) -> tuple:
        """Current ``([F, S] summary, total_weight)`` — the fixed-size
        message exchanged between workers.  Merges whatever sits on the
        ladder (one cross-level stage) without disturbing it."""
        pending = [sw for level in self._levels for sw in level]
        CHECK(pending, "no data added")
        if len(pending) == 1:
            return pending[0]
        return self._merge_group(pending)

    def finalize(self, n_bins: int, allgather_fn=None) -> torch.Tensor:
        """Merged cut points ``[F, n_bins-1]`` f32 on the sketch's device.

        ``allgather_fn(arr) -> [W, ...]`` gathers across workers (numpy
        in, numpy out); every worker computes the same cuts from the
        gathered summaries."""
        local, wt = self.summary()
        if allgather_fn is not None:
            gathered = np.asarray(allgather_fn(local), np.float32)     # [W, F, S]
            wts = np.asarray(allgather_fn(np.asarray(wt, np.float32)),
                             np.float32).reshape(-1)                   # [W]
        else:
            gathered = local[None]
            wts = np.asarray([wt], np.float32)
        merged = self._collapse(np.ascontiguousarray(gathered), wts)  # [F, S]
        return merge_summaries(merged[None], n_bins)


def _digitise(x: torch.Tensor, cuts: torch.Tensor, nan_bin: int,
              dtype: torch.dtype) -> torch.Tensor:
    """Feature-major ``[F, n]`` bins of ``x`` [n, F]: #cuts ≤ value, NaN
    values in ``nan_bin``; each feature searched over its non-NaN cuts
    (see :func:`apply_bins`)."""
    n, F = x.shape
    CHECK(cuts.shape[0] == F, "cuts/feature count mismatch")
    out = torch.empty(F, n, dtype=dtype, device=x.device)
    n_valid = (~torch.isnan(cuts)).sum(1).tolist()
    for f in range(F):
        col = x[:, f].contiguous()
        b = torch.searchsorted(cuts[f, :n_valid[f]].contiguous(), col,
                               right=True)
        out[f] = torch.where(torch.isnan(col), nan_bin, b).to(dtype)
    return out


def apply_bins(x: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Digitise ``x`` [n, F] by per-feature ``cuts`` [F, n_bins-1]: bin =
    #cuts ≤ value.  Returns the FEATURE-major ``[F, n]`` matrix (the
    training layout; JAX's ``apply_bins`` returns ``[n, F]``, which its
    main path then transposes); uint8 when the bins fit (≤ 256), else
    int32.

    NaN cuts (``compute_cuts`` emits them on a feature holding ±inf: the
    top cuts for +inf, every cut for −inf) sort after every number, as in
    ``jnp.searchsorted`` and ``np.searchsorted``: a value counts only the
    non-NaN cuts ≤ it, and a NaN value counts every cut.
    ``torch.searchsorted`` takes a NaN cut for ≤ any value, so each
    feature is searched over its non-NaN cuts, which lie at the front."""
    width = cuts.shape[1]
    return _digitise(x, cuts, width,
                     torch.uint8 if width < 256 else torch.int32)


def apply_bins_missing(x: torch.Tensor, cuts: torch.Tensor,
                       miss_bin: int) -> torch.Tensor:
    """:func:`apply_bins` with a reserved NaN bin: finite values bin into
    ``[0, n_cuts]`` as usual and NaN goes to ``miss_bin`` (the caller
    reserves its top bin).  Feature-major ``[F, n]``; uint8 while
    ``miss_bin < 256``, else int32 — JAX's ``apply_bins_missing``,
    transposed."""
    return _digitise(x, cuts, miss_bin,
                     torch.uint8 if miss_bin < 256 else torch.int32)
