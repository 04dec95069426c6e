"""Gradient histograms for hist-method gradient boosting (PyTorch port).

The counterpart of ``dmlc_core_tpu/ops/histogram.py``.  For every tree
node, feature and bin, accumulate Σgrad and Σhess of the rows that land
there: ``hist[2, n_nodes, F, n_bins]``, plane 0 grad, plane 1 hess, rows
with ``node_id < 0`` adding nothing.  Bins are feature-major ``[F, n]``
uint8 (the JAX main path's layout).

Three kernels, each a hand-written CUDA kernel for Hopper
(``csrc/histogram.cu``) beside a plain PyTorch version of the same
function:

* :func:`hist_kernel` / :func:`hist_plain` — the root histogram (replaces
  the Pallas ``_hist_pallas_kernel``);
* :func:`fused_round_kernel` / :func:`fused_round_plain` — one tree level:
  descend, left-child histograms, sibling subtraction (replaces the Pallas
  ``_fused_round_kernel``);
* :func:`fused_descend_kernel` / :func:`fused_descend_plain` — one tree
  level's descend and left-child histograms in one pass, without the
  subtraction (replaces the Pallas ``_fused_kernel``; the data-parallel
  path, where left children are summed over ranks first).

:func:`descend_kernel` / :func:`descend_plain` is B2's descend on its own:
the first half of the unfused chain and training's final descend, and
with a table of learned missing directions the descend of NaN-as-missing
mode (JAX's ``fused_descend_histogram`` with ``dir_sel``).  Prediction
walks whole forests in one launch instead (``ops/forest.py``).

Each has a LAYOUT MODE (``layout=`` a :class:`~dmlc_core_tpu_torch.ops.
binlayout.BinLayout`): the input is then the physical ``[phys_rows, n]``
matrix (int4-packed and/or bundled), the histograms are in storage space
``[2, N, S, Bs]`` (``Bs = layout.sync_bins``), and the descend decodes the
selected feature's byte back to its ORIGINAL bin id, so thresholds stay in
the original bin space.  One CUDA kernel serves both modes: it reads a
per-physical-row slot table and a per-feature decode table
(:func:`~dmlc_core_tpu_torch.ops.binlayout.kernel_tables`), the identity
without a layout.  The accumulation takes one block per (row chunk,
feature group): a group is a run of physical rows whose cells fit a
block's shared memory (:func:`~dmlc_core_tpu_torch.ops.binlayout.
hist_groups`), so each row's node and g/h are read once a group; the
groups, chunks and digit split are :func:`_accum_plan`'s.  The wrappers
count layout-mode launches apart: ``hist_kernel.layout_launches``,
``fused_round_kernel.layout_launches``.

Both accumulate in int64 FIXED POINT: each row's g/h is rounded to
``rint(v · 2^k)`` with one power-of-two scale per plane
(:func:`hist_scales`, chosen so that ``n · max|q| < 2^53``), summed as
integers and converted to f32 once.  Integer sums do not depend on their
order, so the kernel's concurrent atomics, the plain version's
``index_add_``, any device and any split of the rows over ranks give the
same bytes, run after run.  The ``sync=`` hook of the histogram entry
points is the seam for that last case: it receives the int64 sums
between accumulation and the epilogue (the data-parallel all-reduce),
so an N-rank sum is the 1-rank sum exactly.  On
bf16-exact g/h every sum is exact — equal to the TPU kernel's.  On general
g/h the sum carries at most one f32 rounding plus the ~2^-30·max|g|
quantisation of each row, against ~n ulps for an f32 running sum.

:func:`build_histogram` and :func:`fused_round` are the public entry
points: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import atexit as _atexit
import ctypes
import functools
import math
import os as _os
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ, log_fatal
from dmlc_core_tpu_torch.ops import binlayout as bl

__all__ = ["build_histogram", "fused_round", "fused_descend_histogram",
           "select_feature_bins", "hist_scales", "hist_kernel", "hist_plain",
           "fused_round_kernel", "fused_round_plain", "fused_descend_kernel",
           "fused_descend_plain", "descend_kernel", "descend_plain",
           "reference_histogram",
           "leaves_built_per_round", "bins_bytes_per_round",
           "hist_psum_bytes_per_round", "quantize_hist_partial",
           "dequantize_hist_sum", "sibling_pairs"]

#: int64 sums in, the same shape out (an all-reduce over ranks)
Sync = Callable[[torch.Tensor], torch.Tensor]

#: 2^SCALE_BITS bounds n·max|q|: int64 sums never overflow and convert to
#: double exactly
SCALE_BITS = 53
_SCALE_CLAMP = 100

#: the JAX package's Pallas row tile (its v5e sweeps chose 16384); the
#: one-hot product measurements (``tools/spike_hist_floor.py``) tile rows
#: the same way
_TILE_ROWS = 16384

#: one lock for every wrapper's launch count: worker threads of one
#: process (the elastic recovery layer's in-process workers) launch
#: kernels side by side, and ``+=`` on an attribute is no atomic step
_COUNT_LOCK = threading.Lock()


def _count(wrapper, name: str) -> None:
    """Add one launch to ``wrapper.<name>``."""
    with _COUNT_LOCK:
        setattr(wrapper, name, getattr(wrapper, name) + 1)


#: the JAX package's measured-best ``lo`` per n_build at n_bins=256 (v5e,
#: tile 16384, 10M rows), kept so the factored split ``bin = hi·lo +
#: lo_part`` is the reference's at every level
_LO_MEASURED_256 = {1: 32, 2: 32, 4: 64, 8: 128, 16: 128}


def _lo_factor(n_nodes: int, n_bins: int) -> int:
    """Bin-factor split ``bin = hi·lo + lo_part`` of the one-hot product
    histogram (the JAX package's rule): the measured table at 256 bins,
    else the op-count model ``5·A + 2·lo`` with ``A = 2·n_nodes·hi``.
    The bench's cost model and the one-hot product spike use it; the
    port's own histogram kernels do not factor bins."""
    if n_bins == 256 and n_nodes in _LO_MEASURED_256:
        return _LO_MEASURED_256[n_nodes]
    best, best_cost = 128, None
    for lo in (32, 64, 128):
        if lo > max(n_bins, 8):
            continue
        hi = -(-n_bins // lo)
        A = 2 * n_nodes * hi
        cost = 5 * A + 2 * lo          # construction op counts per element
        if best_cost is None or cost < best_cost:
            best, best_cost = lo, cost
    return best


def leaves_built_per_round(depth: int, grow_policy: str = "depthwise",
                           max_leaves: int = 0) -> int:
    """Histogram BUILDS one boosting round pays (sibling subtraction
    derives the rest for free).  Depth-wise: the root plus every level's
    left children — ``2^(depth-1)``.  Loss-guide: the root plus one per
    expansion — ``max_leaves`` (``2^depth`` when unlimited)."""
    if grow_policy == "lossguide":
        return min(max_leaves, 1 << depth) if max_leaves else 1 << depth
    return 1 if depth <= 1 else 1 << (depth - 1)


def hist_psum_bytes_per_round(depth: int, n_features: int,
                              n_bins: int, *, layout=None,
                              grow_policy: str = "depthwise",
                              max_leaves: int = 0,
                              quant: bool = False) -> int:
    """Per-rank bytes of the histogram-sync allreduce in ONE boosting
    round, as f32 cells (the JAX package's model, value for value).

    Depth-wise syncs the root, then LEFT children only (``2^(ℓ−1)`` at
    level ℓ); loss-guide syncs one node per expansion plus the root.  A
    node is ``[2, S, Bs]`` f32 (``S``/``Bs`` the layout's storage shape).
    ``quant=True`` models the ``DMLC_HIST_QUANT`` int8 sync:
    ``2·S·(Bs + 8)`` bytes a node.  The port's exact sync moves int64
    sums, twice the f32 model."""
    if layout is not None:
        n_features = layout.storage_features
        n_bins = layout.sync_bins
    if quant:
        node_bytes = 2 * n_features * (n_bins + 8)
    else:
        node_bytes = 2 * n_features * n_bins * 4
    if grow_policy == "lossguide":
        return leaves_built_per_round(depth, "lossguide",
                                      max_leaves) * node_bytes
    total = 0
    for level in range(depth):
        n_build = 1 if level == 0 else 1 << (level - 1)
        total += n_build * node_bytes
    return total


def quantize_hist_partial(hist: torch.Tensor, gmax: torch.Tensor):
    """One rank's PARTIAL histogram ``[..., Bs]`` f32 as int8 codes for
    the ``DMLC_HIST_QUANT`` sync, against ``gmax`` ``[..., 1]``, the
    GLOBAL (max-reduced) per-column absolute maximum, so that every rank
    quantises at the same scale.  Returns ``(q int8, scale f32, tot
    f32)``, ``tot`` the exact column total that rides along the sync."""
    scale = torch.clamp(gmax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(hist / scale), -127, 127).to(torch.int8)
    tot = hist.sum(dim=-1, keepdim=True)
    return q, scale, tot


def dequantize_hist_sum(q_sum: torch.Tensor, scale: torch.Tensor,
                        tot_sum: torch.Tensor) -> torch.Tensor:
    """The synced histogram from the summed codes ``q_sum`` (int32),
    the shared ``scale`` and the summed exact column totals: the
    column's quantisation error spread evenly over its cells, so each
    column sums to its exact total (cell error at most ``n_ranks ·
    scale``)."""
    approx = q_sum.to(torch.float32) * scale
    n_cells = approx.shape[-1]
    corr = (tot_sum - approx.sum(dim=-1, keepdim=True)) / n_cells
    return approx + corr


def bins_bytes_per_round(depth: int, rows: int, row_bytes: int, *,
                         grow_policy: str = "depthwise",
                         max_leaves: int = 0,
                         fused: bool = False) -> int:
    """Bin-matrix bytes ONE boosting round streams: the number of full
    passes over the ``[phys_rows, n]`` matrix (``row_bytes`` =
    ``layout.phys_rows`` under a layout, F otherwise) times its size.
    Depth-wise unfused: ``2·depth − 1`` passes (root histogram, a descend
    plus a histogram pass per deeper level, the final descend); the fused
    round collapses each level's descend + histogram into one read —
    ``depth`` passes.  Loss-guide: ``2·leaves − 1`` unfused, ``leaves``
    fused."""
    if grow_policy == "lossguide":
        leaves = leaves_built_per_round(depth, "lossguide", max_leaves)
        passes = leaves if fused else 2 * leaves - 1
    else:
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


def hist_scales(grad: torch.Tensor, hess: torch.Tensor,
                n: Optional[int] = None,
                reduce_max: Optional[Sync] = None) -> Tuple[int, int]:
    """Fixed-point exponents ``(kg, kh)`` for one tree's histograms
    (one device sync).  Every level of the tree uses the same pair, so
    the sibling subtraction ``prev − left`` runs on sums of one scale.

    On one rank of a data-parallel fit pass ``n``, the global row count,
    and ``reduce_max``, the max all-reduce of the ``[2]`` local maxima:
    the scales are then the 1-rank fit's, and so are the bytes."""
    local = (torch.stack([grad.abs().max(), hess.abs().max()])
             if grad.numel() else torch.zeros(2, device=grad.device))
    if reduce_max is not None:
        local = reduce_max(local)
    n = grad.numel() if n is None else n
    if n == 0:
        return _scale_exp(0.0, 0), _scale_exp(0.0, 0)
    gmax, hmax = local.tolist()
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
    """int64 [2, n_nodes·F·n_bins] fixed-point sums over the rows of
    ``bins_t`` (every row adds: the caller drops rows whose node is not
    in ``[0, n_nodes)``); index_add_ per feature — integer, so
    order-free."""
    F, n = bins_t.shape
    qg = _quantize(grad, kg)
    qh = _quantize(hess, kh)
    base = node_h.to(torch.int64) * (F * n_bins)
    acc = torch.zeros(2, n_nodes * F * n_bins, dtype=torch.int64,
                      device=bins_t.device)
    for f in range(F):
        idx = base + (f * n_bins) + bins_t[f].to(torch.int64)
        acc[0].index_add_(0, idx, qg)
        acc[1].index_add_(0, idx, qh)
    return acc


def _left_children(node_id: torch.Tensor) -> torch.Tensor:
    """Even (left-child) ids → their parent's index, everything else −1."""
    return torch.where((node_id >= 0) & (node_id % 2 == 0), node_id >> 1,
                       -1).to(torch.int32)


def hist_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
               grad: torch.Tensor, hess: torch.Tensor, n_nodes: int,
               n_bins: int, kg: int, kh: int,
               layout: Optional[bl.BinLayout] = None, *,
               left_only: bool = False,
               sync: Optional[Sync] = None) -> torch.Tensor:
    """Plain version of :func:`hist_kernel`: the same fixed-point sums,
    bit-identical to it on any device.  Under a ``layout`` the physical
    matrix unpacks to the storage matrix first and the result is
    ``[2, n_nodes, S, layout.sync_bins]``.  ``left_only``: ``node_id``
    holds the next level's ids and only even ones add, at their parent's
    index.  Rows whose (parent) index is not in ``[0, n_nodes)`` add
    nothing, as in the kernel and the JAX package.  ``sync`` maps the
    int64 sums before the conversion."""
    if left_only:
        node_id = _left_children(node_id)
    rows = torch.nonzero((node_id >= 0) & (node_id < n_nodes)).squeeze(1)
    bins_v = bins_t[:, rows]
    if layout is not None:
        bins_v = bl.unpack_matrix(bins_v, layout)
        n_bins = layout.sync_bins
    F = bins_v.shape[0]
    acc = _accum_plain(bins_v, node_id[rows], grad[rows], hess[rows],
                       n_nodes, n_bins, kg, kh)
    if sync is not None:
        acc = sync(acc)
    return torch.stack([_dequantize(acc[0], kg), _dequantize(acc[1], kh)]
                       ).reshape(2, n_nodes, F, n_bins)


def descend_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
                  feat: torch.Tensor, thr: torch.Tensor,
                  by_node: bool = True,
                  layout: Optional[bl.BinLayout] = None,
                  dir_sel: Optional[torch.Tensor] = None,
                  miss_bin: Optional[int] = None) -> torch.Tensor:
    """Route rows one level down: ``2·node + (bins[feat, r] > thr)`` as
    int32, rows with ``node < 0`` staying −1.  ``feat``/``thr`` (and
    ``dir_sel``) are per-node tables (``by_node``) or per-row arrays, in
    the ORIGINAL feature and bin space (under a ``layout`` too).  With
    ``dir_sel`` (learned missing direction, 1 = left) rows in
    ``miss_bin`` follow it instead of the threshold.  The plain version
    of :func:`descend_kernel`, and the one plain descend of the package:
    the plain kernels' descend, and on CPU tensors training's final
    descend, route by it."""
    valid = node_id >= 0
    if by_node:
        key = torch.where(valid, node_id, 0).to(torch.int64)
        feat, thr = feat[key], thr[key]
        if dir_sel is not None:
            dir_sel = dir_sel[key]
    row_bin = select_feature_bins(bins_t, feat, layout=layout)
    go_right = row_bin > thr
    if dir_sel is not None:
        go_right = torch.where(row_bin == miss_bin, dir_sel == 0, go_right)
    return torch.where(valid, 2 * node_id + go_right.to(torch.int32),
                       -1).to(torch.int32)


def fused_round_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
                      feat: torch.Tensor, thr: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      prev_hist: torch.Tensor, n_prev: int, n_bins: int,
                      kg: int, kh: int, by_node: bool = False,
                      layout: Optional[bl.BinLayout] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_round_kernel`: ``(new_node [n],
    hist [2, 2·n_prev, F, n_bins])`` — ``[2, 2·n_prev, S, Bs]`` in
    storage space under a ``layout``."""
    new_node = descend_plain(bins_t, node_id, feat, thr, by_node, layout)
    left = hist_plain(bins_t, new_node, grad, hess, n_prev, n_bins, kg, kh,
                      layout, left_only=True)
    return new_node, sibling_pairs(left, prev_hist)


def sibling_pairs(left: torch.Tensor, prev_hist: torch.Tensor
                  ) -> torch.Tensor:
    """``[2, 2·n_prev, ...]`` children from the left ones and their
    parents: ``2p`` = left, ``2p+1`` = ``prev − left`` in f32 (the
    kernels' epilogue, as JAX's sibling subtraction)."""
    return torch.stack([left, prev_hist - left], dim=2).reshape(
        2, 2 * left.shape[1], *left.shape[2:])


def fused_descend_plain(bins_t: torch.Tensor, node_id: torch.Tensor,
                        feat: torch.Tensor, thr: torch.Tensor,
                        grad: torch.Tensor, hess: torch.Tensor, n_prev: int,
                        n_bins: int, kg: int, kh: int, by_node: bool = False,
                        sync: Optional[Sync] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_descend_kernel`: ``(left_hist
    [2, n_prev, F, n_bins], new_node [n])`` — the descend, then the
    left-child histograms of the new ids, no subtraction."""
    new_node = descend_plain(bins_t, node_id, feat, thr, by_node)
    left = hist_plain(bins_t, new_node, grad, hess, n_prev, n_bins, kg, kh,
                      left_only=True, sync=sync)
    return left, new_node


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _lib():
    from dmlc_core_tpu_torch.ops._build import load_library

    return load_library("histogram")


def _check_launch(rc: int, what: str) -> None:
    if rc != 0:
        log_fatal(f"{what}: CUDA launch failed with cudaError {rc}")


def _check_inputs(bins_t, node_id, grad, hess, n_bins, layout=None):
    CHECK(bins_t.is_cuda, "kernel inputs must be CUDA tensors")
    CHECK(bins_t.dtype == torch.uint8 and bins_t.dim() == 2
          and bins_t.is_contiguous(),
          "bins_t must be a contiguous feature-major [F, n] uint8 tensor")
    if layout is not None:
        CHECK_EQ(bins_t.shape[0], layout.phys_rows,
                 "under a layout bins_t is the physical [phys_rows, n] "
                 "matrix")
    n = bins_t.shape[1]
    for name, t, dt in (("node_id", node_id, torch.int32),
                        ("grad", grad, torch.float32),
                        ("hess", hess, torch.float32)):
        CHECK(t.device == bins_t.device and t.dtype == dt
              and t.shape == (n,) and t.is_contiguous(),
              f"{name} must be a contiguous [{n}] {dt} tensor on "
              f"{bins_t.device}")
    CHECK(1 <= n_bins <= 256, f"n_bins must be in [1, 256], got {n_bins}")


@functools.lru_cache(maxsize=8)
def _device_limits(index: int) -> Tuple[int, int, int, int]:
    """(SMs, shared bytes a block may opt in to, shared bytes of an SM,
    bytes the system reserves a block) of CUDA device ``index``."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        _check_launch(_lib().dmlc_device_limits(ctypes.addressof(out)),
                      "dmlc_device_limits")
    return tuple(out)


#: the accumulation kernel's threads a block, and rows a thread takes a
#: step (``kAccumThreads``, ``4 · kQuads`` in csrc/histogram.cu)
ACCUM_THREADS = 512
ACCUM_STEP_ROWS = 8
#: shared bytes of one physical row's entry in a block's copy of the
#: group table
TABLE_ENTRY_BYTES = 16


class AccumPlan(NamedTuple):
    """How :func:`hist_kernel`'s accumulation cuts its work: the feature
    groups (``rows``, ``groups`` of :func:`~dmlc_core_tpu_torch.ops.
    binlayout.hist_groups`), ``shared`` (False: one group adding into the
    global histogram), each block's shared bytes, the row chunks, and the
    digit split: each row's fixed-point g/h ``q = lo + hi · 2^shift``; a
    block sums at most ``2^(32 − shift)`` rows, each with ``|q| <
    2^qbits``, so its 32-bit digit sums are exact."""
    rows: np.ndarray
    groups: np.ndarray
    shared: bool
    smem: int
    chunks: int
    rows_per_chunk: int
    shift: int
    qbits: int
    #: blocks of a thread-block cluster along the groups (the fused
    #: descend, :func:`_descend_plan`; 1: none)
    cluster: int = 1


@functools.lru_cache(maxsize=64)
def _accum_plan(layout: Optional[bl.BinLayout], n_features: int, n: int,
                n_nodes: int, n_bins: int,
                limits: Tuple[int, int, int, int],
                reserve: int = 0) -> AccumPlan:
    """The accumulation's plan on a card of ``limits``
    (:func:`_device_limits`) for ``n`` rows; ``reserve`` shared bytes a
    block are kept for the fused descend's tables (:func:`_descend_plan`).

    * Digits: :func:`hist_scales` keeps ``n · max|q| < 2^53``, so every
      row has ``|q| ≤ 2^qbits`` with ``qbits = 53 − bitlen(n)``; a row
      that reaches the bound (or any row under a larger scale) adds whole
      into the global histogram.  A block of at most ``2^L`` rows, ``2L ≤
      63 − qbits``, each ``|q| < 2^qbits``, split at ``shift = 32 − L``,
      sums its low digits below 2^32 and its high digits within int32.
    * Groups: physical rows fill a block's shared memory, all a block may
      opt in to less its copy of the table (the fewest groups re-read node
      and g/h the fewest times; PERF.md).
    * Chunks: one block an SM; the fewest waves whose chunks × groups
      fill 90% of their blocks, with at least ``n / 2^L`` chunks (shared)
      and at most one a step's rows of every thread.  A chunk's groups are
      the grid's fast dimension, so they run side by side and read its
      node and g/h from device memory once."""
    sms, optin, _, _ = limits
    slots, _ = bl.kernel_tables(layout, n_features, torch.device("cpu"))
    P = slots.shape[0]
    table = TABLE_ENTRY_BYTES * P
    rows, groups, shared = bl.hist_groups(slots.numpy(), n_nodes, n_bins,
                                          optin - table - reserve)
    qbits = max(1, 53 - max(n, 1).bit_length())
    L = (63 - qbits) // 2
    G = len(groups)
    least = -(-n // (1 << L)) if shared else 1
    most = max(1, -(-n // (ACCUM_THREADS * ACCUM_STEP_ROWS)))
    chunks = least
    for waves in range(1, 65):
        c = waves * sms // G
        if c >= least and 10 * c * G >= 9 * waves * sms:
            chunks = c
            break
    chunks = max(least, min(chunks, most))
    per_chunk = -(-n // chunks)
    rows_per_chunk = max(4, -(-per_chunk // 4) * 4)   # whole quads
    chunks = max(1, -(-n // rows_per_chunk))
    if shared:
        width = (groups[:, 1] - groups[:, 0]).max()
        smem = TABLE_ENTRY_BYTES * int(width) + \
            bl.CELL_BYTES * int(groups[:, 2].max())
    else:
        smem = table
    return AccumPlan(rows, groups, shared, smem + reserve, chunks,
                     rows_per_chunk, 32 - L, qbits)


#: quads of 4 rows a block of the accumulation takes a step
#: (``kStepQuads`` in csrc/histogram.cu)
STEP_QUADS = ACCUM_THREADS * ACCUM_STEP_ROWS // 4
#: shared bytes of a cluster's ids: two steps of four int16 a quad
CLUSTER_IDS_BYTES = 2 * STEP_QUADS * 8


def _split_bytes(n_prev: int) -> int:
    """Shared bytes of the fused descend's per-node split table: an int2
    ``(feat, thr)`` a parent, 16-byte aligned."""
    return 8 * (n_prev + (n_prev & 1))


@functools.lru_cache(maxsize=64)
def _descend_plan(n_features: int, n: int, n_prev: int, n_bins: int,
                  limits: Tuple[int, int, int, int]) -> AccumPlan:
    """The fused descend's plan: :func:`_accum_plan`'s over ``n_prev``
    parents of the plain ``[F, n]`` matrix, its groups balanced
    (:func:`_balanced`), with each block's shared memory also holding the
    per-node split table.  Where the plan with the cluster's ids
    (:data:`CLUSTER_IDS_BYTES`) has an even number of feature groups, pairs
    of a chunk's groups are thread-block clusters whose two blocks share
    the descend of each step's rows, so each row's byte is gathered once a
    pair (10M × 28 × 256: n_prev 16 and 32; larger clusters leave SMs of a
    GPC idle, PERF.md).  Otherwise (one group or an odd number, the
    global-atomic path) every group's block descends its rows itself."""
    reserve = _split_bytes(n_prev)
    base = _balanced(_accum_plan(None, n_features, n, n_prev, n_bins,
                                 limits, reserve), reserve)
    if not base.shared or len(base.groups) < 2:
        return base
    reserve += CLUSTER_IDS_BYTES
    plan = _balanced(_accum_plan(None, n_features, n, n_prev, n_bins,
                                 limits, reserve), reserve)
    if len(plan.groups) % 2:
        return base
    return plan._replace(cluster=2)


def _balanced(plan: AccumPlan, reserve: int) -> AccumPlan:
    """``plan`` (of the plain matrix, with ``reserve`` shared bytes a block
    besides its table and cells; every physical row has the same cells)
    with its rows spread evenly over as many groups, so that no group is a
    small remainder (a block of it idles, in a cluster while its peer
    runs)."""
    if not plan.shared or len(plan.groups) < 2:
        return plan
    P, G = plan.rows.shape[0], len(plan.groups)
    p0, p1, c0, _ = (int(x) for x in plan.groups[0])
    cells = c0 // (p1 - p0)
    rows = plan.rows.copy()
    groups = np.zeros((G, 4), np.int32)
    bounds = [P * g // G for g in range(G + 1)]
    for g in range(G):
        p0, p1 = bounds[g], bounds[g + 1]
        rows[p0:p1, 3] = cells * np.arange(p1 - p0)
        groups[g] = (p0, p1, cells * (p1 - p0), 0)
    width = -(-P // G)
    smem = (TABLE_ENTRY_BYTES + bl.CELL_BYTES * cells) * width + reserve
    return plan._replace(rows=rows, groups=groups, smem=smem)


@functools.lru_cache(maxsize=64)
def _plan_on(layout, n_features, n, n_nodes, n_bins, device):
    """:func:`_accum_plan` for ``device``, its tables there (cached per
    level shape, so the training loop uploads nothing per call)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    plan = _accum_plan(layout, n_features, n, n_nodes, n_bins,
                       _device_limits(index))
    return (plan, torch.from_numpy(plan.rows).to(device),
            torch.from_numpy(plan.groups).to(device))


@functools.lru_cache(maxsize=64)
def _descend_plan_on(n_features, n, n_prev, n_bins, device):
    """:func:`_descend_plan` for ``device``, its tables there (cached as
    :func:`_plan_on`)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    plan = _descend_plan(n_features, n, n_prev, n_bins,
                         _device_limits(index))
    return (plan, torch.from_numpy(plan.rows).to(device),
            torch.from_numpy(plan.groups).to(device))


def _accum_kernel(bins_t, node, grad, hess, n_nodes, n_bins, kg, kh,
                  left_only, layout):
    """int64 ``[2, n_nodes, S, n_bins]`` fixed-point sums (S = F without a
    layout), one block per (feature group, row chunk) of the plan
    :func:`_accum_plan`."""
    P, n = bins_t.shape
    S = P if layout is None else layout.storage_features
    plan, rows, groups = _plan_on(
        layout, P if layout is None else layout.n_features, n, n_nodes,
        n_bins, bins_t.device)
    acc = torch.zeros(2, n_nodes, S, n_bins, dtype=torch.int64,
                      device=bins_t.device)
    rc = _lib().dmlc_hist_accum(
        bins_t.data_ptr(), node.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        n, rows.data_ptr(), groups.data_ptr(), len(plan.groups),
        int(plan.shared), plan.smem, plan.chunks, plan.rows_per_chunk,
        plan.shift, plan.qbits, S, n_nodes, n_bins, 2.0 ** kg, 2.0 ** kh,
        int(left_only), acc.data_ptr(),
        torch.cuda.current_stream(bins_t.device).cuda_stream)
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
                n_bins: int, kg: int, kh: int,
                layout: Optional[bl.BinLayout] = None, *,
                left_only: bool = False,
                sync: Optional[Sync] = None) -> torch.Tensor:
    """CUDA histogram ``[2, n_nodes, F, n_bins]`` f32 (two launches:
    fixed-point accumulation, then the dequantising epilogue; ``sync``
    maps the int64 sums between them).  Under a ``layout``: the physical
    matrix in, ``[2, n_nodes, S, Bs]`` out (the layout mode).
    ``left_only``: ``node_id`` holds the next level's ids and only even
    ones add, at their parent's index.  Counts its calls in
    ``hist_kernel.launches``, its layout-mode calls in
    ``hist_kernel.layout_launches``."""
    if layout is not None:
        n_bins = layout.sync_bins
    _check_inputs(bins_t, node_id, grad, hess, n_bins, layout)
    acc = _accum_kernel(bins_t, node_id, grad, hess, n_nodes, n_bins, kg, kh,
                        left_only, layout)
    if sync is not None:
        acc = sync(acc)
    out = _epilogue_kernel(acc, None, n_nodes, kg, kh)
    if layout is None:
        _count(hist_kernel, "launches")
    else:
        _count(hist_kernel, "layout_launches")
    return out


hist_kernel.launches = 0
hist_kernel.layout_launches = 0


def fused_round_kernel(bins_t: torch.Tensor, node_id: torch.Tensor,
                       feat: torch.Tensor, thr: torch.Tensor,
                       grad: torch.Tensor, hess: torch.Tensor,
                       prev_hist: torch.Tensor, n_prev: int, n_bins: int,
                       kg: int, kh: int, by_node: bool = False,
                       layout: Optional[bl.BinLayout] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA tree level: ``(new_node [n], hist [2, 2·n_prev, F, n_bins])``
    (three launches: descend, left-child accumulation, subtraction
    epilogue).  ``feat``/``thr`` are per-node tables ``[n_prev]``
    (``by_node``) or per-row arrays ``[n]``, in the original feature and
    bin space.  Under a ``layout`` (the layout mode) the matrix is
    physical and ``prev_hist``/``hist`` are in storage space
    ``[.., S, Bs]``.  Counts its calls in ``fused_round_kernel.launches``,
    its layout-mode calls in ``fused_round_kernel.layout_launches``."""
    if layout is not None:
        n_bins = layout.sync_bins
    _check_inputs(bins_t, node_id, grad, hess, n_bins, layout)
    n = bins_t.shape[1]
    S = layout.storage_features if layout is not None else bins_t.shape[0]
    _check_split_tables(bins_t, n_prev if by_node else n, feat=feat, thr=thr)
    CHECK(prev_hist.device == bins_t.device
          and prev_hist.dtype == torch.float32
          and prev_hist.shape == (2, n_prev, S, n_bins)
          and prev_hist.is_contiguous(),
          f"prev_hist must be a contiguous [2, {n_prev}, {S}, {n_bins}] "
          "float32 tensor")
    new_node = _descend_kernel(bins_t, node_id, feat, thr, by_node, layout)
    acc = _accum_kernel(bins_t, new_node, grad, hess, n_prev, n_bins, kg, kh,
                        True, layout)
    hist = _epilogue_kernel(acc, prev_hist, n_prev, kg, kh)
    if layout is None:
        _count(fused_round_kernel, "launches")
    else:
        _count(fused_round_kernel, "layout_launches")
    return new_node, hist


fused_round_kernel.launches = 0
fused_round_kernel.layout_launches = 0


def _descend_kernel(bins_t, node_id, feat, thr, by_node, layout,
                    dir_sel=None, miss_bin=-1):
    """``new_node [n]`` by ``descend_kernel`` (one launch; the layout
    mode's decode under a ``layout``; with ``dir_sel`` the learned
    missing direction of rows in ``miss_bin``): the descend of
    :func:`descend_plain`."""
    n = bins_t.shape[1]
    new_node = torch.empty(n, dtype=torch.int32, device=bins_t.device)
    F = bins_t.shape[0] if layout is None else layout.n_features
    _, dec = bl.kernel_tables(layout, F, bins_t.device)
    rc = _lib().dmlc_descend(
        bins_t.data_ptr(), node_id.data_ptr(), feat.data_ptr(),
        thr.data_ptr(), None if dir_sel is None else dir_sel.data_ptr(),
        int(miss_bin), int(by_node), n, dec.data_ptr(), new_node.data_ptr(),
        torch.cuda.current_stream(bins_t.device).cuda_stream)
    _check_launch(rc, "dmlc_descend")
    return new_node


def descend_kernel(bins_t: torch.Tensor, node_id: torch.Tensor,
                   feat: torch.Tensor, thr: torch.Tensor,
                   by_node: bool = True,
                   layout: Optional[bl.BinLayout] = None,
                   dir_sel: Optional[torch.Tensor] = None,
                   miss_bin: Optional[int] = None) -> torch.Tensor:
    """CUDA descend: ``new_node [n]`` int32, the function of
    :func:`descend_plain` in one launch — B2's descend on its own (the
    unfused chain's first half and training's final descend).  ``feat``/``thr`` (and ``dir_sel``, the learned missing
    direction, 1 = left, for rows in ``miss_bin``) are per-node tables
    (``by_node``) or per-row arrays, int32.  Counts its calls in
    ``descend_kernel.launches``, those with a direction in
    ``descend_kernel.dir_launches``."""
    CHECK(bins_t.is_cuda, "kernel inputs must be CUDA tensors")
    CHECK(bins_t.dtype == torch.uint8 and bins_t.dim() == 2
          and bins_t.is_contiguous(),
          "bins_t must be a contiguous [P, n] uint8 tensor")
    n = bins_t.shape[1]
    CHECK(node_id.device == bins_t.device and node_id.dtype == torch.int32
          and node_id.shape == (n,) and node_id.is_contiguous(),
          f"node_id must be a contiguous [{n}] int32 tensor")
    m = feat.shape[0] if by_node else n
    _check_split_tables(bins_t, m, feat=feat, thr=thr)
    if dir_sel is not None:
        CHECK(miss_bin is not None, "a direction needs its miss_bin")
        _check_split_tables(bins_t, m, dir_sel=dir_sel)
    new_node = _descend_kernel(bins_t, node_id, feat, thr, by_node, layout,
                               dir_sel, -1 if miss_bin is None else miss_bin)
    if dir_sel is None:
        _count(descend_kernel, "launches")
    else:
        _count(descend_kernel, "dir_launches")
    return new_node


descend_kernel.launches = 0
descend_kernel.dir_launches = 0


def _check_split_tables(bins_t, m, **tables):
    for name, t in tables.items():
        CHECK(t.device == bins_t.device and t.dtype == torch.int32
              and t.shape == (m,) and t.is_contiguous(),
              f"{name} must be a contiguous [{m}] int32 tensor")


def fused_descend_kernel(bins_t: torch.Tensor, node_id: torch.Tensor,
                         feat: torch.Tensor, thr: torch.Tensor,
                         grad: torch.Tensor, hess: torch.Tensor,
                         n_prev: int, n_bins: int, kg: int, kh: int,
                         by_node: bool = False,
                         sync: Optional[Sync] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA fused descend: ``(left_hist [2, n_prev, F, n_bins] f32,
    new_node [n])`` — one launch, the accumulation kernel of
    :func:`hist_kernel` with a descend prologue: each row is descended in
    registers and its left child added into the feature groups' shared
    histograms (:func:`_descend_plan`); then the dequantising epilogue
    without ``prev`` (``sync`` maps the int64 sums between them).
    ``feat``/``thr`` are per-node tables ``[n_prev]`` (``by_node``) or
    per-row arrays ``[n]``.  The plain ``[F, n]`` matrix only (no layout
    mode).  Counts its calls in ``fused_descend_kernel.launches``."""
    _check_inputs(bins_t, node_id, grad, hess, n_bins)
    F, n = bins_t.shape
    _check_split_tables(bins_t, n_prev if by_node else n, feat=feat, thr=thr)
    CHECK(n_prev <= 32767, f"n_prev must be at most 32767, got {n_prev}")
    device = bins_t.device
    plan, rows, groups = _descend_plan_on(F, n, n_prev, n_bins, device)
    acc = torch.zeros(2, n_prev, F, n_bins, dtype=torch.int64, device=device)
    new_node = torch.empty(n, dtype=torch.int32, device=device)
    rc = _lib().dmlc_fused_descend(
        bins_t.data_ptr(), node_id.data_ptr(), feat.data_ptr(),
        thr.data_ptr(), int(by_node), grad.data_ptr(), hess.data_ptr(), n,
        rows.data_ptr(), groups.data_ptr(), len(plan.groups),
        int(plan.shared), plan.smem, plan.chunks, plan.rows_per_chunk,
        plan.shift, plan.qbits, plan.cluster, F, n_prev, n_bins, 2.0 ** kg,
        2.0 ** kh, acc.data_ptr(), new_node.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _check_launch(rc, "dmlc_fused_descend")
    if sync is not None:
        acc = sync(acc)
    left = _epilogue_kernel(acc, None, n_prev, kg, kh)
    _count(fused_descend_kernel, "launches")
    return left, new_node


fused_descend_kernel.launches = 0


def warm_launch(device: torch.device, n_features: int, n_bins: int,
                n_nodes: int) -> None:
    """Launch each kernel of the boosting loop once on tiny tensors
    (64 rows of ``n_features``) on ``device``'s current stream: the
    accumulation at 1 and ``n_nodes`` nodes (the deepest level's
    parents, whose plan may take the other instantiation), the epilogue
    without and with a parent, and the descend.  CUDA loads a kernel's
    module at its first launch; the cold-start handle
    (``models.histgbt._KernelWarmup``) calls this so that the first round
    does not pay it.  The results are thrown away and no wrapper's count
    moves: these are no fit's work.  Counts its calls in
    ``warm_launch.launches``."""
    n = 64
    bins = torch.zeros(n_features, n, dtype=torch.uint8, device=device)
    node = torch.zeros(n, dtype=torch.int32, device=device)
    g = torch.ones(n, dtype=torch.float32, device=device)
    for nodes in sorted({1, max(n_nodes, 1)}):
        acc = _accum_kernel(bins, node, g, g, nodes, n_bins, 0, 0, False,
                            None)
        _epilogue_kernel(acc, None, nodes, 0, 0)
        prev = torch.zeros(2, nodes, n_features, n_bins,
                           dtype=torch.float32, device=device)
        _epilogue_kernel(acc, prev, nodes, 0, 0)
    split = torch.zeros(1, dtype=torch.int32, device=device)
    _descend_kernel(bins, node, split, split, True, None)
    _count(warm_launch, "launches")


warm_launch.launches = 0


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launches in this process so far, by the names of
    ``chip_smoke.py``'s kernels line."""
    from dmlc_core_tpu_torch.ops.forest import forest_kernel

    return {"hist": hist_kernel.launches,
            "fused_round": fused_round_kernel.launches,
            "hist_layout": hist_kernel.layout_launches,
            "fused_round_layout": fused_round_kernel.layout_launches,
            "fused_descend": fused_descend_kernel.launches,
            "descend": descend_kernel.launches,
            "descend_dir": descend_kernel.dir_launches,
            "forest": forest_kernel.launches}


def _spool_launches(directory: str) -> None:
    """At exit: this process's :func:`launch_counts` to
    ``directory/launches-<pid>.json``."""
    import json

    path = _os.path.join(directory, f"launches-{_os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(launch_counts(), f)
    _os.replace(path + ".tmp", path)


# DMLC_LAUNCH_SPOOL=<dir>: each process that exits cleanly leaves its
# launch counts there — how a parent counts the kernels its children
# (examples, drill workers, replicas) launched
if _os.environ.get("DMLC_LAUNCH_SPOOL"):
    _atexit.register(_spool_launches, _os.environ["DMLC_LAUNCH_SPOOL"])


# ---------------------------------------------------------------------------
# public entry points (device dispatch)
# ---------------------------------------------------------------------------

def build_histogram(bins_t: torch.Tensor, node_id: torch.Tensor,
                    grad: torch.Tensor, hess: torch.Tensor, n_nodes: int,
                    n_bins: int, *, scales: Optional[Tuple[int, int]] = None,
                    layout: Optional[bl.BinLayout] = None,
                    sync: Optional[Sync] = None) -> torch.Tensor:
    """Return ``hist[2, n_nodes, F, n_bins]`` for the feature-major bin
    matrix ``bins_t [F, n]``.  ``scales`` are the fixed-point exponents of
    :func:`hist_scales` (computed from ``grad``/``hess`` when omitted).
    Under a ``layout`` ``bins_t`` is the physical ``[phys_rows, n]``
    matrix and the result is the storage-space ``[2, n_nodes, S, Bs]``
    (:func:`~dmlc_core_tpu_torch.ops.binlayout.unbundle_hist` maps it back
    for split scoring).  ``sync`` maps the int64 sums before their
    conversion (the data-parallel all-reduce).  CUDA tensors run
    :func:`hist_kernel`, CPU tensors :func:`hist_plain`."""
    kg, kh = scales if scales is not None else hist_scales(grad, hess)
    if bins_t.is_cuda:
        return hist_kernel(bins_t, node_id, grad, hess, n_nodes, n_bins,
                           kg, kh, layout, sync=sync)
    CHECK_EQ(bins_t.device.type, "cpu", "unsupported device")
    return hist_plain(bins_t, node_id, grad, hess, n_nodes, n_bins, kg, kh,
                      layout, sync=sync)


def fused_round(bins_t: torch.Tensor, node_id: torch.Tensor,
                feat_sel: torch.Tensor, thr_sel: torch.Tensor,
                grad: torch.Tensor, hess: torch.Tensor,
                prev_hist: torch.Tensor, n_prev: int, n_bins: int, *,
                score_fn: Optional[Callable] = None, by_node: bool = False,
                scales: Optional[Tuple[int, int]] = None,
                layout: Optional[bl.BinLayout] = None):
    """Advance rows one level AND produce both children's histograms:
    ``(new_node [n], hist [2, 2·n_prev, F, n_bins], score_fn(hist))``
    with ``hist[:, c]`` the histogram of child ``c`` (``2p``/``2p+1``
    interleaved) — the JAX ``fused_round``.

    ``feat_sel``/``thr_sel`` are per-row ``[n]`` as in JAX, or with
    ``by_node=True`` the per-node split tables ``[n_prev]`` (looked up
    per row inside the kernel; the training loop's form), in the
    ORIGINAL feature and bin space.  ``prev_hist`` is the level above's
    ``[2, n_prev, F, n_bins]`` histogram, built at the same ``scales``.
    Under a ``layout`` the matrix is physical and ``prev_hist``/``hist``
    are storage-space ``[.., S, Bs]``."""
    kg, kh = scales if scales is not None else hist_scales(grad, hess)
    feat = feat_sel.to(torch.int32).contiguous()
    thr = thr_sel.to(torch.int32).contiguous()
    if bins_t.is_cuda:
        new_node, hist = fused_round_kernel(
            bins_t, node_id, feat, thr, grad, hess,
            prev_hist.contiguous(), n_prev, n_bins, kg, kh, by_node, layout)
    else:
        CHECK_EQ(bins_t.device.type, "cpu", "unsupported device")
        new_node, hist = fused_round_plain(
            bins_t, node_id, feat, thr, grad, hess, prev_hist, n_prev,
            n_bins, kg, kh, by_node, layout)
    scores = score_fn(hist) if score_fn is not None else None
    return new_node, hist, scores


def fused_descend_histogram(
        bins_t: torch.Tensor, node_id: torch.Tensor,
        feat_sel: torch.Tensor, thr_sel: torch.Tensor,
        grad: torch.Tensor, hess: torch.Tensor, n_prev: int, n_bins: int,
        method: str = "auto", fuse: bool = False,
        dir_sel: Optional[torch.Tensor] = None,
        miss_bin: Optional[int] = None,
        layout: Optional[bl.BinLayout] = None, *, by_node: bool = False,
        scales: Optional[Tuple[int, int]] = None,
        sync: Optional[Sync] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance rows one level and build the new level's LEFT-child
    histograms: ``(left_hist [2, n_prev, F, n_bins], new_node [n])`` with
    ``left_hist[:, p]`` the histogram of parent p's left child (node
    2p); the caller derives the right child by subtraction (after
    ``sync``, the int64 all-reduce, on the data-parallel path) — JAX's
    ``fused_descend_histogram``.

    ``fuse=True`` (``DMLC_TPU_FUSED_DESCEND=1`` in training) runs the
    descend inside the histogram pass: :func:`fused_descend_kernel` on
    CUDA tensors, :func:`fused_descend_plain` on CPU tensors.  Otherwise,
    and as in JAX for the missing direction (``dir_sel``/``miss_bin``)
    and a ``layout``, the unfused chain: the descend (on CUDA tensors
    :func:`descend_kernel`, B2's, which decodes layouts and routes the
    missing direction), then the histogram over left children.
    ``feat_sel``/``thr_sel`` (and ``dir_sel``) are per-row ``[n]``, or
    per-node ``[n_prev]`` with ``by_node``.  ``method`` is accepted for
    the JAX signature (this package has one histogram engine)."""
    del method
    kg, kh = scales if scales is not None else hist_scales(grad, hess)
    feat = feat_sel.to(torch.int32).contiguous()
    thr = thr_sel.to(torch.int32).contiguous()
    if bins_t.is_cuda:
        if fuse and dir_sel is None and layout is None:
            return fused_descend_kernel(bins_t, node_id, feat, thr, grad,
                                        hess, n_prev, n_bins, kg, kh,
                                        by_node, sync)
        if by_node:
            CHECK_EQ(feat.shape[0], n_prev, "per-node tables are [n_prev]")
        new_node = descend_kernel(
            bins_t, node_id, feat, thr, by_node, layout,
            None if dir_sel is None else dir_sel.to(torch.int32).contiguous(),
            miss_bin)
        left = hist_kernel(bins_t, new_node, grad, hess, n_prev, n_bins, kg,
                           kh, layout, left_only=True, sync=sync)
        return left, new_node
    CHECK_EQ(bins_t.device.type, "cpu", "unsupported device")
    if fuse and dir_sel is None and layout is None:
        return fused_descend_plain(bins_t, node_id, feat, thr, grad, hess,
                                   n_prev, n_bins, kg, kh, by_node, sync)
    new_node = descend_plain(bins_t, node_id, feat, thr, by_node, layout,
                             dir_sel, miss_bin)
    left = hist_plain(bins_t, new_node, grad, hess, n_prev, n_bins, kg, kh,
                      layout, left_only=True, sync=sync)
    return left, new_node


def select_feature_bins(bins_t: torch.Tensor, feat_sel: torch.Tensor,
                        layout: Optional[bl.BinLayout] = None
                        ) -> torch.Tensor:
    """``bins_t[feat_sel[r], r]`` for every row r, as int32.  Under a
    ``layout`` the matrix is physical and ``feat_sel`` names ORIGINAL
    features: :func:`~dmlc_core_tpu_torch.ops.binlayout.select_bins`
    decodes the original bin id."""
    if layout is not None:
        return bl.select_bins(bins_t, feat_sel, layout)
    n = bins_t.shape[1]
    return bins_t[feat_sel.to(torch.int64),
                  torch.arange(n, device=bins_t.device)].to(torch.int32)


def reference_histogram(bins, node_id, grad, hess, n_nodes, n_bins):
    """Numpy oracle for tests — row-major ``bins [n, F]``, same
    ``[2, N, F, B]`` shape as :func:`build_histogram`; rows whose node is
    not in ``[0, n_nodes)`` add nothing."""
    bins = np.asarray(bins)
    node_id = np.asarray(node_id)
    out = np.zeros((2, n_nodes, bins.shape[1], n_bins), np.float64)
    for i in range(bins.shape[0]):
        if not 0 <= node_id[i] < n_nodes:
            continue
        for f in range(bins.shape[1]):
            out[0, node_id[i], f, bins[i, f]] += grad[i]
            out[1, node_id[i], f, bins[i, f]] += hess[i]
    return out.astype(np.float32)
