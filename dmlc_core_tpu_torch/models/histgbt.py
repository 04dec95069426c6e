"""Histogram gradient-boosted trees on one GPU (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/histgbt.py`` for its flagship
path: dense, in-core ``HistGBT`` training (``binary:logistic`` /
``reg:squarederror``) with depth-wise or loss-guide growth, the bench's
bin levers, prediction, and ``save_model`` / ``load_model`` in the same
file format.

One device, eager: the round is a Python loop over trees and levels in
the JAX program's level order —

* quantile cuts and binning on the device (``ops.quantile``), giving the
  feature-major uint8 ``[F, n]`` bin matrix;
* with ``DMLC_BIN_PACK=1`` / ``DMLC_FEATURE_BUNDLE=1`` the matrix is
  re-laid out once (``ops.binlayout``: int4 pairs of narrow features,
  bundles of exclusive ones); histograms then stay in storage space and
  split scoring sees them unbundled to the original space;
* per tree, depth-wise (the default): grad/hess, then level 0
  ``build_histogram`` over all rows, each deeper level one ``fused_round``
  (descend + left-child histograms + sibling subtraction) with the split
  tables of the level above, split scoring on the emitted histograms, a
  final descend, leaf values ``−G/(H+λ)·η`` and ``preds += leaf[node]``;
* per tree, loss-guide (``DMLC_GROW_POLICY=lossguide``,
  ``DMLC_MAX_LEAVES``): the root histogram, then ``max_leaves − 1``
  expansions of the open leaf with the best gain, each one
  ``fused_round`` at ``n_prev=1`` over that leaf's rows, with the queue
  kept on the device (no host sync per expansion).

Trees are the JAX package's per-tree numpy arrays (``feat``, ``thr``,
``gain`` ``[depth, 2^(depth-1)]``, ``leaf`` ``[2^depth]``), in the original
feature and bin space whatever the levers, so model files and their
consumers are unchanged.

Data parallel (``mesh=``, a :class:`~dmlc_core_tpu_torch.parallel.mesh.
Mesh` over a ``torch.distributed`` group, one process per GPU): every
rank passes the same global ``X, y``, derives the same cuts from it and
keeps its rows ``shard_row_ranges(n, world)[rank]``.  Histograms are
accumulated per rank as int64 fixed point, summed over ranks by one
``all_reduce`` (the ``sync=`` seam of ``ops.histogram``) and only then
converted and subtracted (``prev − left``), so an N-rank fit writes the
1-rank fit's bytes.  The fixed-point scales take the global ``max|g|``,
``max|h|`` and row count, and layouts the global occupancy.  Without the
fused round a level is ``fused_descend_histogram`` (``fuse`` from
``DMLC_TPU_FUSED_DESCEND``), the sync, then the subtraction, as JAX's
chain.  ``DMLC_HIST_BLOCKS`` keeps its checks and turns the fused round
off, as in JAX; with integer sums JAX's per-block builds and
``_tree_fold`` give the bytes of one build, so the port builds once per
level (``_tree_fold`` is kept for its parity test).  ``DMLC_HIST_QUANT``
(several ranks, no blocks) is JAX's approximate int8 code sync.

Not ported yet: NaN-as-missing, monotone constraints, multiclass and
ranking objectives, row/column sampling, eval sets and early stopping,
continued training, external memory, sharded ingest, one process over
several GPUs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ, LOG, log_fatal
from dmlc_core_tpu_torch.base.parameter import Parameter, field, get_env
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.models.gbt_objectives import (
    EVAL_METRIC_NAMES, OBJECTIVE_NAMES, OBJECTIVES, fold_scale_pos_weight)
from dmlc_core_tpu_torch.models.gbt_split import (_advance_node,
                                                  _make_best_split, _maybe_l1)
from dmlc_core_tpu_torch.ops import binlayout as _bl
from dmlc_core_tpu_torch.ops.histogram import (build_histogram,
                                               dequantize_hist_sum,
                                               fused_descend_histogram,
                                               fused_round,
                                               hist_psum_bytes_per_round,
                                               hist_scales,
                                               quantize_hist_partial,
                                               sibling_pairs)
from dmlc_core_tpu_torch.ops.quantile import (apply_bins, compute_cuts,
                                              xla_cumsum)
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import (Mesh, local_mesh,
                                               shard_row_ranges)
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["HistGBT", "HistGBTParam"]


def _grow_policy() -> str:
    """Tree growth policy (``DMLC_GROW_POLICY``): ``depthwise`` (default)
    or ``lossguide`` (LightGBM-style leaf-wise growth: expand the open
    leaf with the best gain, building ONE histogram per expansion +
    sibling subtraction)."""
    v = os.environ.get("DMLC_GROW_POLICY", "depthwise")
    CHECK(v in ("depthwise", "lossguide"),
          f"DMLC_GROW_POLICY must be 'depthwise' or 'lossguide', got {v!r}")
    return v


def _max_leaves() -> int:
    """``DMLC_MAX_LEAVES``: leaf budget for lossguide growth (0 = full
    2^max_depth, i.e. no budget beyond the depth cap)."""
    return get_env("DMLC_MAX_LEAVES", 0, int)


def _bin_pack_requested() -> bool:
    """``DMLC_BIN_PACK=1``: pack two ≤16-bin features per byte (int4) in
    the feature-major bin matrix (ops.binlayout).  Bit-identical
    histograms."""
    return os.environ.get("DMLC_BIN_PACK", "0") == "1"


def _feature_bundle_requested() -> bool:
    """``DMLC_FEATURE_BUNDLE=1``: fuse mutually-exclusive (near-one-hot)
    feature blocks into one multi-bin storage feature (EFB), with exact
    unbundling at split evaluation (ops.binlayout.detect_bundles)."""
    return os.environ.get("DMLC_FEATURE_BUNDLE", "0") == "1"


def _hist_blocks(data_size: int) -> int:
    """Resolved deterministic-histogram block count ``C`` (0 = off):
    ``DMLC_HIST_BLOCKS=N`` rounded up to a power of two ≥ the data-axis
    size, which must itself be a power of two — the JAX package's knob
    and checks.  The port's integer sums are order-free, so the blocks
    change no byte; the knob turns the fused round off, as in JAX."""
    v = get_env("DMLC_HIST_BLOCKS", 0, int)
    if v <= 0:
        return 0
    CHECK(data_size & (data_size - 1) == 0,
          f"DMLC_HIST_BLOCKS needs a power-of-two data-axis size, "
          f"got {data_size}")
    c = 1
    while c < max(v, data_size):
        c <<= 1
    return c


def _tree_fold(parts):
    """JAX's fixed-order pairwise fold of a power-of-two list of arrays,
    ``((p0+p1)+(p2+p3))+...``.  The training loop does not need it (int64
    sums fold alike in any order); kept, with its parity test, as the
    reference's deterministic reduction."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _fused_round_mode() -> str:
    """``DMLC_FUSED_ROUND``: the fused round kernel (``ops.histogram.
    fused_round``: descend, left children and the sibling subtraction in
    one call).  ``auto`` (default) and ``1`` use it wherever it is
    eligible — one rank, no ``DMLC_HIST_BLOCKS`` (its subtraction needs
    the synced parent) — ``0`` pins the unfused chain."""
    v = os.environ.get("DMLC_FUSED_ROUND", "auto")
    CHECK(v in ("auto", "0", "1"),
          f"DMLC_FUSED_ROUND must be 'auto', '0' or '1', got {v!r}")
    return v


def _hist_quant_requested() -> bool:
    """``DMLC_HIST_QUANT=1``: int8-quantized histogram sync (per-rank
    int8 codes summed as int32, plus exact f32 column totals).
    Approximate; a no-op on one rank and under ``DMLC_HIST_BLOCKS``."""
    return os.environ.get("DMLC_HIST_QUANT", "0") == "1"


def _fused_descend_requested() -> bool:
    """``DMLC_TPU_FUSED_DESCEND=1``: where the fused round is off, each
    level's descend runs inside its histogram pass (the fused descend
    kernel) instead of as a torch pass before it.  Default off, as in
    the JAX package."""
    return os.environ.get("DMLC_TPU_FUSED_DESCEND", "0") == "1"


#: lossguide histogram pool limit (the JAX package's CHECK)
_POOL_LIMIT_BYTES = 256 << 20


class _HistSync:
    """How one fit's histograms become global over its mesh: which
    level engine runs (the fused round on one rank, else the fused
    descend chain), and the syncs between accumulation and the
    subtraction."""

    def __init__(self, mesh: Mesh, n_global: int):
        self.mesh = mesh
        self.world = mesh.size
        self.n_global = n_global
        det_blocks = _hist_blocks(self.world)
        self.fused_rounds = (self.world == 1 and not det_blocks
                             and _fused_round_mode() != "0")
        self.quant = (_hist_quant_requested() and self.world > 1
                      and not det_blocks)
        self.fuse = _fused_descend_requested()
        synced = mesh.initialized and not self.fused_rounds
        #: the int64 all-reduce (``sync=`` of the histogram ops), or None
        self.acc_sync = self._sum if synced and not self.quant else None

    def _sum(self, acc: torch.Tensor) -> torch.Tensor:
        return coll.device_allreduce(acc, self.mesh)

    def _max(self, x: torch.Tensor) -> torch.Tensor:
        return coll.device_allreduce(x, self.mesh, op="max")

    def scales(self, g: torch.Tensor, h: torch.Tensor) -> Tuple[int, int]:
        """The tree's fixed-point scales from the global statistics."""
        if self.world == 1:
            return hist_scales(g, h)
        return hist_scales(g, h, self.n_global, self._max)

    def f32_sync(self, x: torch.Tensor) -> torch.Tensor:
        """A converted histogram after its sync: the int8 code sync of
        ``DMLC_HIST_QUANT`` (global column max, codes, exact totals), or
        the histogram itself (the int64 sums were synced already)."""
        if not self.quant:
            return x
        gmax = self._max(x.abs().amax(dim=-1, keepdim=True))
        q, scale, tot = quantize_hist_partial(x, gmax)
        qs = self._sum(q.to(torch.int32))
        return dequantize_hist_sum(qs, scale, self._sum(tot))

    def round_bytes(self, p: "HistGBTParam", n_features: int,
                    layout: Optional[_bl.BinLayout], grow_policy: str,
                    max_leaves: int) -> int:
        """Bytes one rank's syncs move per boosting round: int64 sums
        (twice the f32 model), or the int8 model under quant; 0 on one
        rank."""
        if self.world <= 1:
            return 0
        model = hist_psum_bytes_per_round(
            p.max_depth, n_features, p.n_bins, layout=layout,
            grow_policy=grow_policy, max_leaves=max_leaves,
            quant=self.quant)
        return model if self.quant else 2 * model


class HistGBTParam(Parameter):
    """Hyperparameters (XGBoost-compatible names where they exist) — the
    JAX package's fields, defaults and bounds, so ``to_dict()`` (and the
    saved payload) is the same dict."""

    n_trees = field(int, default=100, lower_bound=1, description="boosting rounds")
    max_depth = field(int, default=6, lower_bound=1, upper_bound=12)
    n_bins = field(int, default=256, lower_bound=2, upper_bound=256,
                   description="feature quantization bins (max_bin)")
    learning_rate = field(float, default=0.3, lower_bound=0.0, description="eta")
    reg_lambda = field(float, default=1.0, lower_bound=0.0, description="L2 on leaf weights")
    reg_alpha = field(float, default=0.0, lower_bound=0.0,
                      description="L1 on leaf weights (XGBoost alpha: "
                                  "soft-thresholded gradient sums)")
    gamma = field(float, default=0.0, lower_bound=0.0, description="min split gain")
    min_child_weight = field(float, default=1.0, lower_bound=0.0)
    objective = field(str, default="binary:logistic",
                      enum=list(OBJECTIVE_NAMES))
    max_group_size = field(int, default=0, lower_bound=0,
                           description="rank:pairwise — cap docs per "
                                       "query (0 = largest group; larger "
                                       "groups are truncated)")
    num_class = field(int, default=1, lower_bound=1,
                      description="classes for multi:softmax")
    base_score = field(float, default=0.0, description="initial raw margin")
    scale_pos_weight = field(float, default=1.0, lower_bound=0.0,
                             description="binary:logistic — weight "
                                         "multiplier for positive rows "
                                         "(imbalanced data; typical "
                                         "value: #neg/#pos)")
    subsample = field(float, default=1.0, lower_bound=0.0, upper_bound=1.0,
                      description="per-round row subsampling rate")
    colsample_bytree = field(float, default=1.0, lower_bound=0.0,
                             upper_bound=1.0,
                             description="per-tree feature sampling rate")
    seed = field(int, default=0, description="PRNG seed for sampling")
    eval_metric = field(str, default="",
                        enum=[""] + list(EVAL_METRIC_NAMES),
                        description="validation metric (default: the "
                                    "objective's own)")
    monotone_constraints = field(list, default=(),
                                 description="per-feature -1/0/+1 monotone "
                                             "constraints (empty = none)")
    hist_method = field(str, default="auto",
                        enum=["auto", "segment", "matmul", "pallas"],
                        description="histogram engine of the JAX package; "
                                    "this package has one (fixed-point "
                                    "sums) and keeps the field for model "
                                    "files")


#: the JAX package's tree-array key order (sorted, as its pytree fetch
#: returns them) — part of save_model's bytes
_TREE_KEYS = ("feat", "gain", "leaf", "thr")


class HistGBT:
    """Train/predict API on one device per process.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``; the CPU runs the
    plain PyTorch versions of the kernels.  With no GPU present the
    default raises rather than running on the CPU.  ``mesh`` is the data
    axis (default: the process group's, size 1 without one); on several
    ranks each process passes its own card as ``device``."""

    _MODEL_MAGIC = b"DCTGBT01"
    #: rows per device batch in predict (bounds the transient f32 X and
    #: bin matrices on the device)
    _PREDICT_BATCH = 2_000_000

    def __init__(self, param: Optional[HistGBTParam] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None, **kwargs: Any):
        self.param = param or HistGBTParam()
        if kwargs:
            self.param.init(kwargs)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh()
        #: the level engine and syncs of the fit in progress
        self._sync: Optional[_HistSync] = None
        self._obj = self._objective()
        self.cuts: Optional[torch.Tensor] = None        # [F, n_bins-1] f32
        self.trees: List[Dict[str, np.ndarray]] = []
        self.best_iteration: Optional[int] = None
        self.best_score: Optional[float] = None
        self._early_stopped = False
        self.last_fit_seconds: Optional[float] = None
        #: seconds from the start of the boosting loop to the end of each
        #: tree (the first tree also pays the first use of every kernel)
        self.last_tree_times: List[float] = []
        self.last_bin_seconds: Optional[float] = None
        self._train_preds: Optional[torch.Tensor] = None
        #: global rows of the last fit (train_margins' gather)
        self._train_rows = 0
        #: the storage layout of the last training matrix (None: plain)
        self._bin_layout: Optional[_bl.BinLayout] = None

    def _objective(self):
        p = self.param
        CHECK(p.objective in OBJECTIVES,
              f"objective {p.objective!r} is not ported to this package yet "
              f"(ported: {OBJECTIVES.list_all_names()})")
        CHECK(p.num_class == 1, "multi:softmax is not ported yet")
        return OBJECTIVES[p.objective]

    def _check_fit_params(self) -> None:
        p = self.param
        CHECK(p.subsample == 1.0 and p.colsample_bytree == 1.0,
              "row/column sampling is not ported yet")
        CHECK(not any(int(v) for v in p.monotone_constraints),
              "monotone_constraints are not ported yet")

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray,
            weight: Optional[np.ndarray] = None,
            cuts: Optional[torch.Tensor] = None) -> "HistGBT":
        """Boost ``n_trees`` rounds on ``X`` [n, F] / ``y`` [n]; bin cuts
        are computed from ``X`` unless ``cuts`` are given."""
        CHECK(len(self.trees) == 0,
              "continued training is not ported yet (fit a fresh model)")
        self.cuts = None
        dd = self.make_device_data(X, y, weight=weight, cuts=cuts)
        return self.fit_device(dd)

    def make_device_data(self, X: np.ndarray, y: np.ndarray,
                         weight: Optional[np.ndarray] = None,
                         cuts: Optional[torch.Tensor] = None
                         ) -> Dict[str, Any]:
        """Quantise + upload a training set once, for repeated fits: cuts
        (computed on the device, or ``cuts`` / the model's own), the
        feature-major uint8 ``[F, n]`` bin matrix — re-laid out to the
        physical ``[phys_rows, n]`` matrix when ``DMLC_BIN_PACK`` /
        ``DMLC_FEATURE_BUNDLE`` find a non-trivial layout (``"layout"``) —
        labels and weights on the device.  Sets ``self.cuts`` if unset.

        On a data axis of several ranks ``X``/``y`` are the GLOBAL rows
        (the same on every rank): cuts come from all of them, the bins,
        labels and weights are this rank's ``mesh.row_range(n)``."""
        p = self.param
        t0 = get_time()
        X = np.ascontiguousarray(X, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float32)
        n, F = X.shape
        CHECK_EQ(len(y), n, "X/y row mismatch")
        if np.isnan(X).any():
            log_fatal("X contains NaN: NaN-as-missing is not ported yet "
                      "(impute, or train with the JAX package)")
        weight = fold_scale_pos_weight(p, y, weight)
        lo, hi = self.mesh.row_range(n)
        X_d = torch.from_numpy(X).to(self.device)
        w_d = (None if weight is None else
               torch.from_numpy(np.ascontiguousarray(weight, np.float32)
                                ).to(self.device))
        if cuts is not None:
            self.cuts = torch.as_tensor(cuts, dtype=torch.float32,
                                        device=self.device)
        elif self.cuts is None:
            self.cuts = compute_cuts(X_d, p.n_bins, weight=w_d)
        CHECK_EQ(int(self.cuts.shape[1]), p.n_bins - 1,
                 "cuts width must be n_bins-1")
        bins_t = apply_bins(X_d[lo:hi], self.cuts)
        layout = None
        if _bin_pack_requested() or _feature_bundle_requested():
            layout = self._compute_bin_layout(bins_t, F, X_d)
            if layout is not None:
                bins_t = _bl.pack_matrix(bins_t, layout)
        del X_d
        self._bin_layout = layout
        dd = {
            "bins_t": bins_t,
            "y_d": torch.from_numpy(y[lo:hi]).to(self.device),
            "w_d": (torch.ones(hi - lo, dtype=torch.float32,
                               device=self.device)
                    if w_d is None else w_d[lo:hi].contiguous()),
            "n": hi - lo,
            "n_global": n,
            "n_features": F,
            "layout": layout,
        }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_bin_seconds = get_time() - t0
        return dd

    def _compute_bin_layout(self, bins_t: torch.Tensor, n_features: int,
                            X_d: torch.Tensor) -> Optional[_bl.BinLayout]:
        """The packed/bundled storage layout of a binned ``[F, n]``
        matrix (``DMLC_BIN_PACK`` / ``DMLC_FEATURE_BUNDLE``), or None.

        Occupancy counts come from the binned rows (the cuts cannot say
        how many bins a feature really uses), summed over the ranks.
        Bundles are proposed on the first ``min(n, 65536)`` global rows
        of ``X_d``, as the JAX package samples, and each is verified
        exactly on every rank's matrix before it is kept — every rank
        derives the 1-rank fit's layout."""
        p = self.param
        counts = _bl.bin_counts(bins_t, p.n_bins)
        if self.mesh.size > 1:
            counts = coll.device_allreduce(
                torch.from_numpy(counts.astype(np.int64)).to(self.device),
                self.mesh).cpu().numpy().astype(np.int32)
        bundles: tuple = ()
        if _feature_bundle_requested():
            m = min(int(X_d.shape[0]), 1 << 16)
            sample = apply_bins(X_d[:m], self.cuts).cpu().numpy()
            proposed = _bl.detect_bundles(sample, counts, p.n_bins)
            dflt = _bl.default_bins(counts)
            bundles = tuple(b for b in proposed
                            if self._bundle_exclusive(bins_t, b, dflt))
            if len(proposed) != len(bundles):
                LOG("INFO", "feature bundling: %d/%d sampled bundles "
                    "survived exact full-data verification",
                    len(bundles), len(proposed))
        layout = _bl.compute_layout(counts, n_features, p.n_bins,
                                    pack=_bin_pack_requested(),
                                    bundles=bundles)
        if layout is not None:
            LOG("INFO", "bin layout: %d features -> %d physical rows "
                "(%d int4 pairs, %d bundles; %d/%d sync bins)",
                n_features, layout.phys_rows, len(layout.pairs),
                sum(1 for mm in layout.members if len(mm) > 1),
                layout.sync_bins, p.n_bins)
        return layout

    def _bundle_exclusive(self, bins_t: torch.Tensor, bundle,
                          defaults) -> bool:
        """Exact mutual-exclusivity check of one proposed bundle over the
        full matrix (every rank's rows): no row may have two members off
        their DEFAULT bin."""
        nz = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                         device=bins_t.device)
        for f in bundle:
            nz += (bins_t[int(f)] != int(defaults[int(f)])).to(torch.int32)
        worst = nz.max(dim=0, keepdim=True).values if nz.numel() else (
            torch.zeros(1, dtype=torch.int32, device=nz.device))
        if self.mesh.size > 1:
            worst = coll.device_allreduce(worst, self.mesh, op="max")
        return int(worst) <= 1

    def _lossguide_leaves(self, n_features: int) -> int:
        """The leaf budget of a lossguide tree, with the JAX package's
        checks: at least 2 leaves, the histogram pool at most 256 MB."""
        p = self.param
        n_leaf = 1 << p.max_depth
        max_leaves = _max_leaves()
        CHECK(max_leaves >= 0, "DMLC_MAX_LEAVES must be >= 0")
        leaves = min(max_leaves, n_leaf) if max_leaves else n_leaf
        CHECK(leaves >= 2,
              f"lossguide needs >= 2 leaves (max_depth={p.max_depth}, "
              f"DMLC_MAX_LEAVES={max_leaves})")
        CHECK(leaves * 2 * n_features * p.n_bins * 4 <= _POOL_LIMIT_BYTES,
              f"lossguide histogram pool would exceed 256 MB "
              f"({leaves} leaves x {n_features} features x {p.n_bins} "
              f"bins) — lower DMLC_MAX_LEAVES or max_depth")
        return leaves

    def fit_device(self, dd: Dict[str, Any]) -> "HistGBT":
        """Boost ``n_trees`` rounds over a :meth:`make_device_data`
        handle; appends to ``self.trees``, sets ``last_fit_seconds``.
        The growth policy is read from ``DMLC_GROW_POLICY`` here."""
        self._check_fit_params()
        p = self.param
        bins_t, y_d, w_d = dd["bins_t"], dd["y_d"], dd["w_d"]
        layout = dd.get("layout")
        self._bin_layout = layout
        CHECK(bins_t.dtype == torch.uint8, "n_bins > 256 is not supported")
        self._sync = _HistSync(self.mesh, dd.get("n_global", dd["n"]))
        policy = _grow_policy()
        sync_bytes = self._sync.round_bytes(p, dd["n_features"], layout,
                                            policy, _max_leaves())
        if policy == "lossguide":
            leaves = self._lossguide_leaves(dd["n_features"])
            heap = _heap_tables(p.max_depth, self.device)

            def grow(g, h):
                return self._grow_tree_lossguide(bins_t, g, h, layout,
                                                 leaves, heap)
        else:
            def grow(g, h):
                return self._grow_tree(bins_t, g, h, layout)
        preds = torch.full((dd["n"],), p.base_score, dtype=torch.float32,
                           device=self.device)
        self.last_tree_times = []
        t0 = get_time()
        for _ in range(p.n_trees):
            g, h = self._obj.grad_hess(preds, y_d)
            g = g * w_d
            h = h * w_d
            tree, delta = grow(g, h)
            coll.record_hist_psum(sync_bytes)
            preds = preds + delta
            # the copy to the host waits for the tree, so the timestamp
            # marks when its device work finished
            self.trees.append({k: tree[k].cpu().numpy() for k in _TREE_KEYS})
            self.last_tree_times.append(get_time() - t0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_fit_seconds = get_time() - t0
        self._train_preds = preds
        self._train_rows = dd.get("n_global", dd["n"])
        return self

    def _grow_tree(self, bins_t: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor, layout: Optional[_bl.BinLayout] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One depth-wise tree on (g, h) → (tree arrays, margin delta).

        Level 0 builds the root histogram over all rows; every deeper
        level is one fused round: rows descend by the level above's split
        tables, only LEFT children get a built histogram, the right child
        is parent − left.  Where the fused round is off (data parallel,
        ``DMLC_HIST_BLOCKS``, ``DMLC_FUSED_ROUND=0``) a level is the fused
        descend, the sync of the left children, then the subtraction.
        All levels share one fixed-point scale pair, so every histogram's
        bytes are independent of summation order.  Under a ``layout``
        histograms and the subtraction stay in storage space; split
        scoring sees them unbundled."""
        p = self.param
        depth, B = p.max_depth, p.n_bins
        lam, alpha = p.reg_lambda, p.reg_alpha
        half = max((1 << depth) >> 1, 1)
        split = _make_best_split(B, lam, p.gamma, p.min_child_weight,
                                 alpha=alpha)
        split_leaf = _make_best_split(B, lam, p.gamma, p.min_child_weight,
                                      with_child_sums=True, alpha=alpha)

        def best_split(hs):
            return split(_bl.unbundle_hist(hs, layout, B))

        def best_split_leaf(hs):
            return split_leaf(_bl.unbundle_hist(hs, layout, B))

        sync = self._sync
        scales = sync.scales(g, h)
        node = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                           device=bins_t.device)
        feats, thrs, gains = [], [], []
        prev_hist = feat = thr = gsum = hsum = None
        for level in range(depth):
            n_nodes = 1 << level
            score_fn = best_split_leaf if level == depth - 1 else best_split
            if level == 0:
                hist = sync.f32_sync(build_histogram(
                    bins_t, node, g, h, 1, B, scales=scales, layout=layout,
                    sync=sync.acc_sync))
                scores = score_fn(hist)
            elif sync.fused_rounds:
                node, hist, scores = fused_round(
                    bins_t, node, feat, thr, g, h, prev_hist, n_nodes >> 1,
                    B, score_fn=score_fn, by_node=True, scales=scales,
                    layout=layout)
            else:
                left, node = fused_descend_histogram(
                    bins_t, node, feat, thr, g, h, n_nodes >> 1, B,
                    fuse=sync.fuse, layout=layout, by_node=True,
                    scales=scales, sync=sync.acc_sync)
                hist = sibling_pairs(sync.f32_sync(left), prev_hist)
                scores = score_fn(hist)
            prev_hist = hist
            if level == depth - 1:
                feat, thr, gn, gsum, hsum = scores
            else:
                feat, thr, gn = scores
            pad = half - n_nodes
            feats.append(torch.nn.functional.pad(feat, (0, pad)))
            thrs.append(torch.nn.functional.pad(thr, (0, pad)))
            gains.append(torch.nn.functional.pad(gn, (0, pad)))
        # final descend into the leaf layer
        leaf_node = _advance_node(bins_t, node, feat, thr, layout)
        leaf_w = -_maybe_l1(gsum, alpha) / (hsum + lam)
        leaf = leaf_w * p.learning_rate
        tree = {"feat": torch.stack(feats), "thr": torch.stack(thrs),
                "gain": torch.stack(gains), "leaf": leaf}
        return tree, leaf[leaf_node]

    def _grow_tree_lossguide(self, bins_t: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor,
                             layout: Optional[_bl.BinLayout], n_leaves: int,
                             heap: Tuple[torch.Tensor, torch.Tensor]
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        torch.Tensor]:
        """One LEAF-WISE tree on (g, h) → (tree arrays, margin delta).

        LightGBM lossguide, as the JAX package grows it: a gain-priority
        queue over open leaves (heap ids: root 1, children 2i / 2i+1); each
        of the ``n_leaves − 1`` expansions splits the open leaf with the
        best candidate gain (first maximum), builds ONE histogram — the
        left child over that leaf's rows — and derives the right child
        from the parent's pooled histogram, both in one ``fused_round``
        at ``n_prev=1`` (where the fused round is off: the fused descend,
        the sync, then the subtraction).  An expansion whose best gain is
        not above ``gamma`` changes nothing (the ``ok`` gate).

        The queue lives on the device and every update is a masked
        tensor op (writes that the gate cancels go to spare entries past
        the end), so the loop launches all ``n_leaves − 1`` expansions
        without a host sync, as the JAX ``scan`` does.  Trees come out in
        depth-wise's complete-tree arrays: unexpanded slots carry feat 0,
        thr B−1, gain 0, leaf −0.0."""
        p = self.param
        depth, B = p.max_depth, p.n_bins
        lam, alpha, gamma = p.reg_lambda, p.reg_alpha, p.gamma
        dev = bins_t.device
        n = bins_t.shape[1]
        n_leaf = 1 << depth
        half = max(n_leaf >> 1, 1)
        NH = 1 << (depth + 1)
        L = n_leaves
        levels, poss = heap
        split = _make_best_split(B, lam, gamma, p.min_child_weight,
                                 alpha=alpha)
        sync = self._sync
        scales = sync.scales(g, h)

        def eval_nodes(hist_st):
            """(feat, thr, gain, tot_g, tot_h) per node of a storage-space
            histogram stack [2, N, S, Bs]."""
            ev = _bl.unbundle_hist(hist_st, layout, B)
            f_, t_, gn_ = split(ev)
            tot = xla_cumsum(ev[:, :, :1])[..., 0, -1]        # [2, N]
            return f_, t_, gn_, tot[0], tot[1]

        i32, f32 = torch.int32, torch.float32
        # ---- root ----
        node = torch.ones(n, dtype=i32, device=dev)          # heap ids
        root = sync.f32_sync(build_histogram(
            bins_t, torch.zeros(n, dtype=i32, device=dev), g, h, 1, B,
            scales=scales, layout=layout, sync=sync.acc_sync))
        f0, t0, g0, tg0, th0 = eval_nodes(root)
        # per heap id, plus two spare entries (NH, NH+1) for cancelled writes
        open_ = torch.zeros(NH + 2, dtype=torch.bool, device=dev)
        open_[1] = True
        leaf_g = torch.zeros(NH + 2, dtype=f32, device=dev)
        leaf_h = torch.zeros(NH + 2, dtype=f32, device=dev)
        leaf_g[1:2] = tg0
        leaf_h[1:2] = th0
        cand_feat = torch.zeros(NH + 2, dtype=i32, device=dev)
        cand_thr = torch.full((NH + 2,), B - 1, dtype=i32, device=dev)
        cand_gain = torch.full((NH + 2,), float("-inf"), dtype=f32,
                               device=dev)
        cand_feat[1:2] = f0
        cand_thr[1:2] = t0
        cand_gain[1:2] = g0
        rec_feat = torch.zeros(NH + 2, dtype=i32, device=dev)
        rec_thr = torch.full((NH + 2,), B - 1, dtype=i32, device=dev)
        rec_gain = torch.zeros(NH + 2, dtype=f32, device=dev)
        # histogram pool of the open leaves, storage space, + 2 spare slots
        pool = torch.zeros((L + 2, 2) + tuple(root.shape[2:]), dtype=f32,
                           device=dev)
        pool[0] = root[:, 0]
        pool_id = torch.zeros(L + 2, dtype=i32, device=dev)
        pool_id[0] = 1
        can_grow = levels < depth                               # [NH]

        for _ in range(L - 1):
            gains = torch.where(open_[:NH] & can_grow, cand_gain[:NH],
                                float("-inf"))
            hc = torch.argmax(gains).view(1)                    # int64 [1]
            ok = gains.index_select(0, hc) > gamma              # [1]
            fsel = cand_feat.index_select(0, hc)
            tsel = cand_thr.index_select(0, hc)
            hc_eff = torch.where(ok, hc, NH)
            rec_feat.index_copy_(0, hc_eff, fsel)
            rec_thr.index_copy_(0, hc_eff, tsel)
            rec_gain.index_copy_(0, hc_eff, cand_gain.index_select(0, hc))
            take = ok & (node == hc)                            # [n]
            slot = torch.argmax((pool_id[:L] == hc).to(i32)).view(1)
            # one fused round: descend the leaf's rows, build the left
            # child, subtract it from the pooled parent
            node_in = torch.where(take, 0, -1).to(i32)
            parent = pool.index_select(0, slot).transpose(0, 1)
            if sync.fused_rounds:
                nn, pair, sc2 = fused_round(
                    bins_t, node_in, fsel, tsel, g, h, parent, 1, B,
                    score_fn=eval_nodes, by_node=True, scales=scales,
                    layout=layout)
            else:
                left, nn = fused_descend_histogram(
                    bins_t, node_in, fsel, tsel, g, h, 1, B, fuse=sync.fuse,
                    layout=layout, by_node=True, scales=scales,
                    sync=sync.acc_sync)
                pair = sibling_pairs(sync.f32_sync(left), parent)
                sc2 = eval_nodes(pair)
            node = torch.where(take, 2 * node + (nn == 1).to(i32), node)
            f2, t2, g2, tg2, th2 = sc2
            # children at the depth cap never expand
            child_lvl = levels.index_select(0, (2 * hc).clamp(max=NH - 1))
            g2 = torch.where(child_lvl < depth, g2, float("-inf"))
            kids = torch.cat([torch.where(ok, 2 * hc, NH),
                              torch.where(ok, 2 * hc + 1, NH + 1)])
            open_.index_fill_(0, hc_eff, False)
            open_.index_fill_(0, kids, True)
            leaf_g.index_copy_(0, kids, tg2)
            leaf_h.index_copy_(0, kids, th2)
            cand_feat.index_copy_(0, kids, f2)
            cand_thr.index_copy_(0, kids, t2)
            cand_gain.index_copy_(0, kids, g2)
            # pool: the parent's slot takes the left child, the first free
            # slot (searched before that overwrite) the right
            free = torch.argmax((pool_id[:L] == 0).to(i32)).view(1)
            slots = torch.cat([torch.where(ok, slot, L),
                               torch.where(ok, free, L + 1)])
            pool.index_copy_(0, slots, pair.transpose(0, 1))
            pool_id.index_copy_(0, slots, torch.cat([2 * hc, 2 * hc + 1]
                                                    ).to(i32))

        # leaf table in depth-wise's positional layout: every position an
        # open leaf does not own is an empty leaf, exactly −0.0
        is_open = open_[:NH]
        w_all = (-_maybe_l1(leaf_g[:NH], alpha) / (leaf_h[:NH] + lam)
                 ) * p.learning_rate
        spare = n_leaf + torch.arange(NH, device=dev)
        pos = torch.where(is_open, poss, spare)
        leaf = torch.full((n_leaf + NH,), -0.0, dtype=f32, device=dev)
        leaf.index_copy_(0, pos, w_all)
        leaf = leaf[:n_leaf]

        def per_level(a):
            return torch.stack([
                torch.nn.functional.pad(a[1 << lv:1 << (lv + 1)],
                                        (0, half - (1 << lv)))
                for lv in range(depth)])

        tree = {"feat": per_level(rec_feat), "thr": per_level(rec_thr),
                "gain": per_level(rec_gain), "leaf": leaf}
        delta = torch.where(is_open, w_all, 0.0)[node.to(torch.int64)]
        return tree, delta

    def train_margins(self) -> np.ndarray:
        """Raw training-set margins after :meth:`fit`, of all global rows
        in their order (on several ranks: gathered from every rank)."""
        CHECK(self._train_preds is not None, "call fit first")
        preds = self._train_preds
        world = self.mesh.size
        if world == 1:
            return preds.cpu().numpy()
        ranges = shard_row_ranges(self._train_rows, world)
        width = max(hi - lo for lo, hi in ranges)
        padded = torch.nn.functional.pad(preds, (0, width - preds.numel()))
        gathered = coll.device_allgather(padded, self.mesh).cpu()
        return torch.cat([gathered[r * width:r * width + hi - lo]
                          for r, (lo, hi) in enumerate(ranges)]).numpy()

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _resolve_trees(self, n_trees: Optional[int]):
        """Trees used for prediction: explicit count, else the early-stop
        winner of a loaded model, else all."""
        if (n_trees is None and self._early_stopped
                and self.best_iteration is not None):
            n_trees = self.best_iteration + 1
        return self.trees if n_trees is None else self.trees[:n_trees]

    def _stacked_trees(self, trees: List[Dict[str, np.ndarray]]
                       ) -> Dict[str, torch.Tensor]:
        """The forest as stacked device tensors ``[T, ...]`` (eager torch
        has no compiled program to keep at a fixed shape, so no
        padding)."""
        return {k: torch.from_numpy(np.stack([t[k] for t in trees])
                                    ).to(self.device)
                for k in ("feat", "thr", "leaf")}

    def predict(self, X: np.ndarray, output_margin: bool = False,
                n_trees: Optional[int] = None) -> np.ndarray:
        """Margins (``output_margin``) or transformed predictions [n]."""
        CHECK(self.cuts is not None, "predict before fit")
        CHECK(len(self.trees) > 0, "no trees trained")
        X = np.ascontiguousarray(X, dtype=np.float32)
        if np.isnan(X).any():
            log_fatal("predict: X contains NaN and this model has no "
                      "missing-value support")
        stacked = self._stacked_trees(self._resolve_trees(n_trees))
        outs = []
        for lo in range(0, len(X), self._PREDICT_BATCH):
            xb = torch.from_numpy(X[lo:lo + self._PREDICT_BATCH]
                                  ).to(self.device)
            margin = _predict_trees(
                apply_bins(xb, self.cuts), stacked["feat"], stacked["thr"],
                stacked["leaf"], self.param.max_depth,
                torch.full((len(xb),), self.param.base_score,
                           dtype=torch.float32, device=self.device))
            out = margin if output_margin else self._obj.transform(margin)
            outs.append(out.cpu().numpy())
        if not outs:
            return np.zeros(0, np.float32)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def predict_proba(self, X: np.ndarray,
                      n_trees: Optional[int] = None) -> np.ndarray:
        """``[n, 2]`` columns ``(1−p, p)`` for ``binary:logistic``."""
        CHECK(self.param.objective == "binary:logistic",
              f"predict_proba needs a classification objective, got "
              f"{self.param.objective!r}")
        margin = self.predict(X, output_margin=True, n_trees=n_trees)
        prob1 = self._obj.transform(torch.from_numpy(margin)).numpy()
        return np.stack([1.0 - prob1, prob1], axis=1)

    # ------------------------------------------------------------------
    # weights: (param, cuts, trees) in and out, and model files
    # ------------------------------------------------------------------
    def to_state(self) -> Dict[str, Any]:
        """The model as the payload ``save_model`` writes: param dict,
        cuts ``[F, n_bins-1]`` f32 and the per-tree numpy arrays."""
        CHECK(self.cuts is not None and len(self.trees) > 0,
              "to_state before fit")
        return {
            "param": self.param.to_dict(),
            "cuts": self.cuts.cpu().numpy(),
            "trees": self.trees,
            "best_iteration": self.best_iteration,
            "best_score": self.best_score,
            "early_stopped": self._early_stopped,
            "missing": False,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any],
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "HistGBT":
        """A model from a ``to_state`` / ``save_model`` payload (numpy
        arrays) — from this package or the JAX package — that predicts
        the same."""
        CHECK(not state.get("missing", False),
              "NaN-as-missing models are not ported yet")
        param = HistGBTParam()
        param.init(state["param"])
        model = cls(param, device=device)
        model.cuts = torch.as_tensor(np.array(state["cuts"], np.float32),
                                     device=model.device)
        model.trees = [{k: np.asarray(t[k]) for k in _TREE_KEYS}
                       for t in state["trees"]]
        model.best_iteration = state.get("best_iteration")
        model.best_score = state.get("best_score")
        model._early_stopped = state.get("early_stopped", False)
        return model

    def save_model(self, uri: str) -> None:
        """Serialize params + bin cuts + trees to a Stream URI — the JAX
        package's ``DCTGBT01`` file, byte for byte."""
        from dmlc_core_tpu_torch.io.serializer import write_obj
        from dmlc_core_tpu_torch.io.stream import Stream

        state = self.to_state()
        s = Stream.create(uri, "w")
        try:
            s.write(self._MODEL_MAGIC)
            write_obj(s, state)
        finally:
            s.close()

    @classmethod
    def load_model(cls, uri: str,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "HistGBT":
        """Inverse of :meth:`save_model`; reads either package's files."""
        from dmlc_core_tpu_torch.io.serializer import read_obj
        from dmlc_core_tpu_torch.io.stream import Stream

        s = Stream.create(uri, "r")
        try:
            magic = s.read_exact(len(cls._MODEL_MAGIC))
            CHECK_EQ(bytes(magic), cls._MODEL_MAGIC,
                     f"not a HistGBT model: {uri}")
            payload = read_obj(s)
        finally:
            s.close()
        return cls.from_state(payload, device=device)


def _heap_tables(depth: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per heap id ``i`` in ``[0, 2^(depth+1))``: its level and its leaf
    position (the leftmost depth-level descendant), as device tensors."""
    NH = 1 << (depth + 1)
    level = np.zeros(NH, np.int32)
    pos = np.zeros(NH, np.int64)
    for i in range(1, NH):
        lvl = i.bit_length() - 1
        level[i] = lvl
        pos[i] = (i - (1 << lvl)) << (depth - lvl)
    return (torch.from_numpy(level).to(device),
            torch.from_numpy(pos).to(device))


def _predict_trees(bins_t, feats, thrs, leaves, depth: int, init):
    """Sum leaf values over trees onto ``init`` [n], tree by tree in
    order (the summation order of training's margin updates)."""
    total = init
    for t in range(feats.shape[0]):
        node = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                           device=bins_t.device)
        for level in range(depth):
            node = _advance_node(bins_t, node, feats[t, level],
                                 thrs[t, level])
        total = total + leaves[t][node]
    return total
