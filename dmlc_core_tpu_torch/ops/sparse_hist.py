"""Sparse histogram substrate: ragged per-feature bins over PRESENT entries
(PyTorch port).

The counterpart of ``dmlc_core_tpu/ops/sparse_hist.py``, the substrate of
:class:`~dmlc_core_tpu_torch.models.histgbt_sparse.SparseHistGBT` for data
the dense ``[F, n]`` bin matrix cannot hold (bag-of-words or hashed
one-hot rows, F ≈ 10⁴–10⁶ at under 1% density):

* **Ragged global bin space**: feature ``j`` owns bins
  ``[bin_ptr[j], bin_ptr[j+1])``, one more than its cut count, so
  ``total_bins`` tracks the data's distinct values, not ``F × max_bins``.
* **Histograms over entries**: one scatter-add of per-row gradients over
  ``node(row) × total_bins + gb(entry)`` per level, O(nnz).
* **Absent = missing**: a node's absent mass for feature j is
  ``G_node − Σ present_j``; the split scan tries it on both sides (the
  learned default direction).

The host passes (cuts, candidates, their merge, entry binning, CSR rows)
are numpy copies of the JAX package's, bit-equal to them.  The device
functions are torch array code, as the JAX versions are XLA array code
(``segment_sum``, ``.at[].set``): no Pallas kernel is reached here, so no
hand kernel stands in.

Sums follow the port-wide grid-order rule (ROADMAP B): each row's ``g·w``
and ``h·w`` are quantised to int64 fixed point with the dense engine's
per-tree power-of-two scales (:func:`~dmlc_core_tpu_torch.ops.histogram.
hist_scales`) and added by ``index_add_`` as exact integers (in float64,
below 2^53), so any order of the entries, and any device, gives the same
bytes.  Routing looks up each row's entry of its node's split feature in
the entries sorted by ``row · F + feature`` (:class:`EntryIndex`).  The split scan's
within-feature prefixes are exact int64 cumulative sums (JAX scatters into
a padded ``[F, b_max]`` layout to keep its f32 prefixes per feature; exact
integers need no padding), converted to f32 once before JAX's gain
arithmetic, argmax tie order and ½-gain acceptance.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.ops.histogram import _quantize

__all__ = ["SparseCuts", "build_sparse_cuts", "cuts_from_ptr", "sparse_cut_candidates",
           "merge_sparse_cut_candidates", "bin_sparse_entries",
           "csr_rows", "level_histogram", "node_totals",
           "sparse_best_split", "route_level", "quantize_rows",
           "dequantize_sums", "EntryIndex", "route_sorted"]


class SparseCuts(NamedTuple):
    """Ragged per-feature quantile cuts.

    ``cut_vals[cut_ptr[j]:cut_ptr[j+1]]`` are feature j's strictly
    increasing cut points; its local bin of value v is
    ``#cuts_j ≤ v  ∈ [0, ncuts_j]`` and its global bin is
    ``bin_ptr[j] + local`` with ``bin_ptr[j+1] − bin_ptr[j] =
    ncuts_j + 1``.  ``feat_of_bin[gb]`` inverts the layout.
    """
    cut_vals: np.ndarray     # [total_cuts] f32
    cut_ptr: np.ndarray      # [F+1] int64
    bin_ptr: np.ndarray      # [F+1] int64
    feat_of_bin: np.ndarray  # [total_bins] int32

    @property
    def n_features(self) -> int:
        return len(self.cut_ptr) - 1

    @property
    def total_bins(self) -> int:
        return int(self.bin_ptr[-1])


# ---------------------------------------------------------------------------
# host passes (numpy, bit-equal to the JAX package's)
# ---------------------------------------------------------------------------

def _feature_value_keys(cols: np.ndarray, values: np.ndarray) -> np.ndarray:
    """uint64 keys ordering (feature, f32 value) as the pair sorts: the
    feature in the high word, the value's bits made order-preserving in
    the low word (negative floats flipped whole, positive ones with the
    sign bit set).  -0.0 keys below +0.0."""
    bits = np.ascontiguousarray(values, np.float32).view(np.uint32)
    low = np.where(bits & np.uint32(0x80000000), ~bits,
                   bits | np.uint32(0x80000000))
    return (np.asarray(cols).astype(np.uint64) << np.uint64(32)) | low


def _feature_value_keys_t(cols: torch.Tensor, values: torch.Tensor
                          ) -> torch.Tensor:
    """:func:`_feature_value_keys` in torch, as int64 (F < 2^31), on the
    tensors' device."""
    bits = values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    low = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                      bits | 0x80000000)
    return (cols.to(torch.int64) << 32) | low


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _t(a, device, dtype) -> torch.Tensor:
    """``a`` (numpy or torch) as a ``dtype`` tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(
        a, dtype=torch.empty(0, dtype=dtype).numpy().dtype)).to(device)


def _host(a, dtype) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype)


def _has_negative_zero(values) -> bool:
    if isinstance(values, torch.Tensor):
        return bool((torch.signbit(values) & (values == 0)).any())
    return bool((np.signbit(values) & (values == 0)).any())


def _sorted_by_feature(cols: np.ndarray, values: np.ndarray) -> np.ndarray:
    """``values`` in the order of the JAX package's ``lexsort((values,
    cols))``.  Without -0.0 among the values, equal keys hold equal
    bits, so one unstable sort of the (feature, value) keys gives the
    same array much faster; with -0.0 the stable lexsort runs (it keeps
    -0.0 and +0.0, equal as floats, in their input order)."""
    if not _has_negative_zero(values):
        return _key_values(np.sort(_feature_value_keys(cols, values)))
    return values[np.lexsort((values, cols))]


def _key_values(keys: np.ndarray) -> np.ndarray:
    low = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    bits = np.where(low & np.uint32(0x80000000),
                    low & np.uint32(0x7FFFFFFF), ~low)
    return bits.view(np.float32)


def _candidates_t(cols: torch.Tensor, values: torch.Tensor,
                  n_features: int, nb: int) -> np.ndarray:
    """:func:`sparse_cut_candidates`' gather on the card: the sorted
    (feature, value) keys there, only the ``[F, nb]`` candidates back."""
    keys = torch.sort(_feature_value_keys_t(cols, values)).values
    low = keys & 0xFFFFFFFF
    bits = torch.where(low >= 0x80000000, low & 0x7FFFFFFF,
                       low ^ 0xFFFFFFFF)
    cv = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)
    counts = torch.bincount(cols, minlength=n_features)
    starts = torch.cumsum(counts, 0) - counts
    k = torch.arange(1, nb + 1, device=cols.device)
    m = counts[:, None]
    idx = starts[:, None] + torch.minimum(
        torch.ceil((k[None, :] * m).to(torch.float64) / (nb + 1)).to(
            torch.int64), (m - 1).clamp(min=0))
    cand = cv[idx.clamp(max=cv.numel() - 1)]
    cand[counts == 0] = float("nan")
    return cand.cpu().numpy()


def sparse_cut_candidates(cols: np.ndarray, values: np.ndarray,
                          n_features: int, max_bins: int = 256,
                          device=None) -> np.ndarray:
    """Per-feature cut CANDIDATES ``[F, max_bins-1]`` (f32; an all-NaN
    row for a feature with no local entries).

    One ``lexsort`` of the entries by (feature, value), then each
    feature's candidates are gathered at evenly spaced ranks of its own
    segment (unweighted ranks).  This fixed-shape matrix is also the
    distributed message: workers allgather their candidate matrices and
    :func:`merge_sparse_cut_candidates` re-quantiles the union.
    On a CUDA ``device`` (``cols``/``values`` numpy or tensors) the sort
    and the gather run there, with the same result.
    """
    CHECK(max_bins >= 2, "need at least 2 bins")
    if _is_cuda(device):
        c = _t(cols, device, torch.int64)
        v = _t(values, device, torch.float32)
        CHECK(c.numel() == v.numel(), "cols/values length mismatch")
        if c.numel():
            CHECK(int(c.max()) < n_features, "feature index out of range")
            CHECK(int(c.min()) >= 0, "negative feature index")
            CHECK(bool(torch.isfinite(v).all()),
                  "sparse values must be finite (absent entries ARE the "
                  "missing mass; explicit NaN has no sparse meaning)")
            if not _has_negative_zero(v):
                return _candidates_t(c, v, n_features, max_bins - 1)
    cols = _host(cols, np.int64)
    values = _host(values, np.float32)
    CHECK(len(cols) == len(values), "cols/values length mismatch")
    if len(cols):
        CHECK(int(cols.max()) < n_features, "feature index out of range")
        CHECK(int(cols.min()) >= 0, "negative feature index")
        CHECK(np.isfinite(values).all(),
              "sparse values must be finite (absent entries ARE the "
              "missing mass; explicit NaN has no sparse meaning)")
    cv = _sorted_by_feature(cols, values)
    counts = np.bincount(cols, minlength=n_features)          # [F]
    starts = np.concatenate([[0], np.cumsum(counts)])         # [F+1]
    nb = max_bins - 1                                         # cut slots
    k = np.arange(1, nb + 1)                                  # [nb]
    m = counts[:, None]                                       # [F, 1]
    idx = starts[:-1, None] + np.minimum(
        np.ceil(k[None, :] * m / (nb + 1)).astype(np.int64),
        np.maximum(m - 1, 0))
    cand = cv[np.minimum(idx, len(cv) - 1 if len(cv) else 0)] \
        if len(cv) else np.zeros((n_features, nb), np.float32)  # [F, nb]
    cand[counts == 0] = np.nan
    return cand


def merge_sparse_cut_candidates(cands: np.ndarray) -> SparseCuts:
    """Merge ``[W, F, max_bins-1]`` worker candidate matrices into
    ragged :class:`SparseCuts`.

    Per feature the union of the workers' points is re-quantiled onto the
    candidates' own grid width (NaN rows contribute nothing; workers weigh
    equally).  With ``W = 1`` the merge is the identity on the
    candidates.  Only strictly increasing runs are kept; a feature with
    no finite candidate keeps 0 cuts (1 bin, never a split).
    """
    cands = np.asarray(cands, np.float32)
    W, F, nb = cands.shape
    pts = np.sort(cands.transpose(1, 0, 2).reshape(F, W * nb), axis=1)
    m = (~np.isnan(pts)).sum(axis=1, keepdims=True)           # [F, 1]
    k = np.arange(1, nb + 1)                                  # [nb]
    # candidate j of a worker sits at quantile (j+1)/(nb+1) of its shard;
    # rank ceil(k·(m+1)/(nb+1))−1 of the union puts target k/(nb+1) back
    # on the same grid, and makes W=1 the identity
    idx = np.clip(np.ceil(k[None, :] * (m + 1) / (nb + 1)).astype(
        np.int64) - 1, 0, np.maximum(m - 1, 0))
    cand = np.take_along_axis(pts, idx, axis=1)               # [F, nb]
    keep = np.ones_like(cand, bool)
    keep[:, 1:] = cand[:, 1:] > cand[:, :-1]
    keep[m[:, 0] == 0] = False
    keep &= ~np.isnan(cand)
    ncuts = keep.sum(axis=1)                                  # [F]
    cut_ptr = np.concatenate([[0], np.cumsum(ncuts)])
    cut_vals = cand[keep].astype(np.float32)
    widths = ncuts + 1
    bin_ptr = np.concatenate([[0], np.cumsum(widths)])
    feat_of_bin = np.repeat(np.arange(F, dtype=np.int32), widths)
    return SparseCuts(cut_vals, cut_ptr.astype(np.int64),
                      bin_ptr.astype(np.int64), feat_of_bin)


def cuts_from_ptr(cut_vals: np.ndarray, cut_ptr: np.ndarray) -> SparseCuts:
    """The :class:`SparseCuts` of saved ``cut_vals`` / ``cut_ptr`` (the
    bin layout follows from the cut counts)."""
    cut_ptr = np.asarray(cut_ptr, np.int64)
    widths = np.diff(cut_ptr) + 1
    return SparseCuts(np.asarray(cut_vals, np.float32), cut_ptr,
                      np.concatenate([[0], np.cumsum(widths)]).astype(
                          np.int64),
                      np.repeat(np.arange(len(widths), dtype=np.int32),
                                widths))


def build_sparse_cuts(cols: np.ndarray, values: np.ndarray, n_features: int,
                      max_bins: int = 256, device=None) -> SparseCuts:
    """Single-worker cuts: candidates, then the (W=1) merge — one code
    path with the distributed build."""
    cand = sparse_cut_candidates(cols, values, n_features, max_bins, device)
    return merge_sparse_cut_candidates(cand[None])


def bin_sparse_entries(cols: np.ndarray, values: np.ndarray,
                       cuts: SparseCuts, device=None):
    """Global bin id per entry (a grouped searchsorted): the JAX package
    sorts cuts and entries together by (feature, value, kind), cuts
    before entries at an equal value, and takes an entry's local bin as
    the running cut count within its feature's segment.  Here, for
    finite values, one searchsorted of (feature, value) keys gives the
    same counts: numpy int32 on the host, or an int64 tensor on
    ``device`` when given (``cols``/``values`` numpy or tensors)."""
    if device is not None:
        c = _t(cols, device, torch.int64)
        v = _t(values, device, torch.float32)
        if c.numel() == 0:
            return torch.zeros(0, dtype=torch.int64, device=device)
        if np.isfinite(cuts.cut_vals).all() and bool(
                torch.isfinite(v).all()):
            ck = _t(_cut_keys(cuts).view(np.int64), device, torch.int64)
            ek = _feature_value_keys_t(c, v + 0.0)
            local = torch.searchsorted(ck, ek, right=True)
            return (_t(cuts.bin_ptr, device, torch.int64)[c] + local
                    - _t(cuts.cut_ptr, device, torch.int64)[c])
        return _t(bin_sparse_entries(_host(cols, np.int64),
                                     _host(values, np.float32), cuts),
                  device, torch.int64)
    cols = np.asarray(cols)
    values = np.asarray(values, np.float32)
    if len(values) == 0:
        return np.zeros(0, np.int32)
    if np.isfinite(cuts.cut_vals).all() and np.isfinite(values).all():
        ek = _feature_value_keys(cols, values + np.float32(0))
        local = (np.searchsorted(_cut_keys(cuts), ek, side="right")
                 - cuts.cut_ptr[cols])
        return (cuts.bin_ptr[cols] + local).astype(np.int32)
    C = len(cuts.cut_vals)
    n = len(values)
    cut_cols = np.repeat(np.arange(cuts.n_features),
                         np.diff(cuts.cut_ptr)).astype(cols.dtype)
    all_cols = np.concatenate([cut_cols, cols])
    all_vals = np.concatenate([cuts.cut_vals, values])
    kind = np.concatenate([np.zeros(C, np.int8), np.ones(n, np.int8)])
    order = np.lexsort((kind, all_vals, all_cols))
    is_cut = kind[order] == 0
    run_cuts = np.cumsum(is_cut)                     # cuts so far, global
    pos_of_entry = np.empty(C + n, np.int64)
    pos_of_entry[order] = np.arange(C + n)
    entry_pos = pos_of_entry[C:]
    local = run_cuts[entry_pos] - cuts.cut_ptr[cols]
    return (cuts.bin_ptr[cols] + local).astype(np.int32)


def _cut_keys(cuts: SparseCuts) -> np.ndarray:
    """The cuts' (feature, value) keys, sorted (cuts ascend within each
    feature and the features ascend); -0.0 keys as +0.0, as floats
    compare."""
    cut_cols = np.repeat(np.arange(cuts.n_features, dtype=np.int64),
                         np.diff(cuts.cut_ptr))
    return _feature_value_keys(cut_cols, cuts.cut_vals + np.float32(0))


def csr_rows(indptr: np.ndarray) -> np.ndarray:
    """Row index per entry from a CSR indptr (int32)."""
    indptr = np.asarray(indptr)
    return np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                     np.diff(indptr))


# ---------------------------------------------------------------------------
# device functions (torch)
# ---------------------------------------------------------------------------

def quantize_rows(g: torch.Tensor, h: torch.Tensor, kg: int, kh: int
                  ) -> torch.Tensor:
    """``[n, 2]`` int64 fixed point of each row's (g, h) at the scales
    ``2^kg`` / ``2^kh`` (``ops.histogram.hist_scales``)."""
    return torch.stack([_quantize(g, kg), _quantize(h, kh)], dim=1)


def _dq(acc: torch.Tensor, k: int) -> torch.Tensor:
    """f32 of int64 fixed-point sums: one correctly rounded conversion,
    then the exact power-of-two scale (``ops.histogram._dequantize``'s
    value)."""
    return acc.to(torch.float32) * (2.0 ** -k)


def dequantize_sums(acc: torch.Tensor, kg: int, kh: int) -> torch.Tensor:
    """f32 of int64 sums ``[2, ...]`` (g plane, h plane), each rounded
    once."""
    return torch.stack([_dq(acc[0], kg), _dq(acc[1], kh)])


# The scatter-adds below add the int64 fixed-point values as float64:
# |q| sums of a tree stay below 2^53 (hist_scales' bound), so every
# partial sum is an exact integer in float64 and any order of the adds
# gives the same bits, while float64 atomics are native on the card
# (torch's int64 atomics are compare-and-swap loops, slow under the
# contention of popular bins).

def _level_histogram_q(row_e, gb_e, node, qf, n_build: int,
                       total_bins: int, level: int) -> torch.Tensor:
    nd = node
    if level > 0:
        nd = torch.where((nd >= 0) & (nd % 2 == 0), nd >> 1, -1)
    n_entry = nd[row_e]                                  # [nnz]
    # only the entries of rows in a built node add (one host sync)
    keep = torch.nonzero(n_entry >= 0).squeeze(1)
    seg = n_entry[keep].to(torch.int64) * total_bins + gb_e[keep]
    rows = row_e[keep]
    acc = torch.zeros(2, n_build * total_bins, dtype=torch.float64,
                      device=qf.device)
    for p in range(2):
        acc[p].index_add_(0, seg, qf[:, p].contiguous()[rows])
    return acc.to(torch.int64).reshape(2, n_build, total_bins)


def level_histogram(row_e, gb_e, node, g, h, *, n_build: int,
                    total_bins: int, level: int, kg: int, kh: int
                    ) -> torch.Tensor:
    """Left-child gradient histograms for one level, int64 fixed point
    ``[2, n_build, total_bins]`` (:func:`dequantize_sums` gives JAX's f32
    values), by one scatter-add over the entries.

    ``node`` [n] is each row's node at this level (−1 = padding).  At
    level 0 every row builds node 0; deeper levels build LEFT children
    only (right = parent − left): entries whose row's node is odd or
    invalid add nothing."""
    qf = quantize_rows(g, h, kg, kh).to(torch.float64)
    return _level_histogram_q(row_e.to(torch.int64), gb_e.to(torch.int64),
                              node, qf, n_build, total_bins, level)


def _node_totals_q(node, qf, n_nodes: int) -> torch.Tensor:
    valid = (node >= 0)[:, None]
    acc = torch.zeros(n_nodes, 2, dtype=torch.float64, device=qf.device)
    acc.index_add_(0, node.clamp(min=0).to(torch.int64),
                   torch.where(valid, qf, 0.0))
    return acc.T.to(torch.int64)


def node_totals(node, g, h, *, n_nodes: int, kg: int, kh: int
                ) -> torch.Tensor:
    """Per-node TOTAL g/h over all rows (present + absent mass), int64
    fixed point ``[2, n_nodes]``; padding rows (node < 0) add nothing."""
    return _node_totals_q(node, quantize_rows(g, h, kg, kh).to(
        torch.float64), n_nodes)


def _score(G: torch.Tensor, H: torch.Tensor, lam: float,
           alpha: float) -> torch.Tensor:
    if alpha > 0.0:
        from dmlc_core_tpu_torch.models.gbt_split import _soft_threshold

        t = _soft_threshold(G, alpha)
        return t * t / (H + lam)
    return G * G / (H + lam)


def _feature_prefix(x: torch.Tensor, bin_ptr_d: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact within-feature prefix sums of int64 ``x`` [N, TB] and each
    feature's total [N, F]: one cumulative sum over the flat bin space
    whose running value restarts at every feature (each feature's first
    bin takes away the previous feature's total), so no partial sum
    exceeds one feature's own mass.  The totals are a segmented sum in
    float64 (exact below 2^53, as the histograms)."""
    N = x.shape[0]
    widths = (bin_ptr_d[1:] - bin_ptr_d[:-1])[None, :].expand(
        N, -1).contiguous()
    tot = torch.segment_reduce(x.to(torch.float64), "sum", lengths=widths,
                               axis=1).to(torch.int64)
    adj = x.clone()
    adj[:, bin_ptr_d[1:-1]] -= tot[:, :-1]
    # each row starts with feature 0 and restarts after the row before:
    # one flat scan over every row (a device-wide scan, where a scan
    # along dim 1 takes one block a row)
    adj[1:, 0] -= tot[:-1, -1]
    return torch.cumsum(adj.reshape(-1), dim=0).reshape(x.shape), tot


def sparse_best_split(hist: torch.Tensor, totals: torch.Tensor,
                      bin_ptr_d: torch.Tensor, feat_of_bin_d: torch.Tensor,
                      last_mask: torch.Tensor, *, kg: int, kh: int,
                      lam: float, gamma: float, mcw: float,
                      alpha: float = 0.0):
    """Sparsity-aware split chooser over the ragged flat bin space.

    ``hist`` [2, N, TB] int64 (present-entry g/h per global bin),
    ``totals`` [2, N] int64 (ALL rows), both at the scales ``2^kg`` /
    ``2^kh``; ``bin_ptr_d`` [F+1], ``feat_of_bin_d`` [TB], ``last_mask``
    [TB] (True at each feature's LAST bin, not a threshold).  For every
    candidate bin the absent mass ``totals − feature_present`` is tried
    on both sides.  Returns (feat [N] int32, thr_local [N] int32, dir [N]
    bool (True = missing left), gain [N] f32), with the dense engine's
    degenerate convention: ½·gain ≤ gamma → feat 0 / thr = width(f0)−1 /
    dir True (everyone goes left), gain 0.

    The prefixes, the absent mass and every side's sums are exact int64,
    each converted to f32 once; the gains are then JAX's f32 arithmetic,
    the argmax its first-index tie order over the global bin, and the
    acceptance its ½-gain test."""
    feat_of_bin_d = feat_of_bin_d.to(torch.int64)
    bin_ptr_d = bin_ptr_d.to(torch.int64)
    glq, tgq = _feature_prefix(hist[0], bin_ptr_d)
    hlq, thq = _feature_prefix(hist[1], bin_ptr_d)
    gtq = totals[0][:, None]                             # [N, 1] all rows
    htq = totals[1][:, None]
    miss_gq = gtq - tgq[:, feat_of_bin_d]                # absent mass
    miss_hq = htq - thq[:, feat_of_bin_d]
    del tgq, thq
    gt = _dq(gtq, kg)
    ht = _dq(htq, kh)
    parent = _score(gt, ht, lam, alpha)

    def side_gain(gq, hq):
        gl, hl = _dq(gq, kg), _dq(hq, kh)
        gr, hr = _dq(gtq - gq, kg), _dq(htq - hq, kh)
        gn = _score(gl, hl, lam, alpha) + _score(gr, hr, lam, alpha) - parent
        ok = (hl >= mcw) & (hr >= mcw)
        return torch.where(ok, gn, -torch.inf)

    gain_r = side_gain(glq, hlq)                         # missing right
    gain_l = side_gain(glq + miss_gq, hlq + miss_hq)     # missing left
    del glq, hlq, miss_gq, miss_hq
    gain = torch.maximum(gain_r, gain_l)
    dir_l = gain_l > gain_r
    gain = torch.where(last_mask[None, :], -torch.inf, gain)
    best = torch.argmax(gain, dim=1)                     # [N] global bin
    best_gain = torch.gather(gain, 1, best[:, None])[:, 0]
    feat = feat_of_bin_d[best]
    thr = (best - bin_ptr_d[feat]).to(torch.int32)
    dirv = torch.gather(dir_l, 1, best[:, None])[:, 0]
    # XGBoost's convention, as the dense chooser: the acceptance test and
    # the reported gain both carry the ½ factor
    ok = 0.5 * best_gain > gamma
    width0 = (bin_ptr_d[1] - bin_ptr_d[0]).to(torch.int32)
    feat = torch.where(ok, feat, 0).to(torch.int32)
    thr = torch.where(ok, thr, width0 - 1)
    dirv = torch.where(ok, dirv, True)
    gain_out = torch.where(ok, 0.5 * best_gain, 0.0)
    return feat, thr, dirv, gain_out


class EntryIndex:
    """The entries keyed by ``row · F + feature``, sorted (each key once:
    one entry per (row, feature)), with their global bins in the same
    order — built once a fit or a predict, so that routing finds a row's
    entry of its node's split feature by a binary search per row instead
    of a pass over every entry (:func:`route_sorted`)."""

    def __init__(self, row_e: torch.Tensor, feat_e: torch.Tensor,
                 gb_e: torch.Tensor, n_features: int):
        keys = row_e.to(torch.int64) * n_features + feat_e.to(torch.int64)
        gb = gb_e.to(torch.int64)
        if keys.numel() > 1 and not bool((keys[1:] > keys[:-1]).all()):
            keys, perm = torch.sort(keys)
            gb = gb[perm]
        self.keys = keys
        self.gb = gb
        self.n_features = n_features


def route_sorted(index: EntryIndex, node, feat, thr, dirv, bin_ptr_d
                 ) -> torch.Tensor:
    """:func:`route_level` over an :class:`EntryIndex`: the same nodes,
    each row's split-feature entry found by ``searchsorted``."""
    n = node.shape[0]
    valid = node >= 0
    safe = torch.where(valid, node, 0).to(torch.int64)
    f = feat[safe].to(torch.int64)
    split_gb = bin_ptr_d.to(torch.int64)[f] + thr[safe]
    right = ~dirv[safe]                                  # missing: dir
    if index.keys.numel():
        want = torch.arange(n, device=node.device) * index.n_features + f
        pos = torch.searchsorted(index.keys, want).clamp(
            max=index.keys.numel() - 1)
        hit = index.keys[pos] == want
        right = torch.where(hit, index.gb[pos] > split_gb, right)
    routed = 2 * safe + right.to(torch.int64)
    return torch.where(valid, routed, -1).to(torch.int32)


def route_level(row_e, gb_e, node, feat, thr, dirv, bin_ptr_d,
                feat_of_bin_d) -> torch.Tensor:
    """Advance every row one level down using only PRESENT entries.

    A row follows its node's missing direction unless it holds an entry
    of the node's split feature (at most one: ``SparseHistGBT`` refuses
    duplicate (row, feature) entries), which then decides by its bin.
    One integer-coded scatter: bit 1 = "entry present", bit 0 = its
    right-verdict.  Padding rows stay −1.  (The model routes by
    :func:`route_sorted`, the same nodes.)"""
    row_e = row_e.to(torch.int64)
    gb_e = gb_e.to(torch.int64)
    bin_ptr_d = bin_ptr_d.to(torch.int64)
    feat_e = feat_of_bin_d[gb_e]
    n = node.shape[0]
    valid = node >= 0
    safe = torch.where(valid, node, 0).to(torch.int64)
    default = torch.where(dirv[safe], 0, 1)              # missing: 1 = left
    n_e = node[row_e]
    ok_e = n_e >= 0
    safe_e = torch.where(ok_e, n_e, 0).to(torch.int64)
    split_f = feat[safe_e].to(torch.int64)
    split_gb = bin_ptr_d[split_f] + thr[safe_e]          # [nnz] threshold
    match = ok_e & (feat_e.to(torch.int64) == split_f)
    side = match & (gb_e > split_gb)                     # right verdict
    seg = torch.where(ok_e, row_e, n)
    code = torch.zeros(n + 1, dtype=torch.int32, device=node.device)
    code.index_add_(0, seg, match.to(torch.int32) * 2 + side.to(torch.int32))
    code = code[:-1]
    routed = 2 * safe + torch.where(code >= 2, code & 1, default)
    return torch.where(valid, routed, -1).to(torch.int32)
