"""Sparse high-dimensional hist-GBT (LibSVM's natural workloads), PyTorch
port.

The counterpart of ``dmlc_core_tpu/models/histgbt_sparse.py``:
:class:`SparseHistGBT` boosts over CSR rows for data whose dense ``[F, n]``
bin matrix cannot exist (bag-of-words or hashed one-hot rows, F ≈
10⁴–10⁶ at under 1% density), over ``ops.sparse_hist``'s ragged flat bin
space:

* a level's histogram is one exact fixed-point scatter-add over the
  present entries, O(nnz), never O(n·F);
* per-feature bin counts follow the distinct values (an indicator costs 2
  bins, not 256);
* absent entries ARE the missing mass: every split tries the node's
  absent g/h on both sides and records the better default direction.

Trees store (feat, thr, dir, gain, leaf) per level as the JAX package's
do (``thr`` a LOCAL bin of the feature's ragged cut range), and model
files (magic ``DCTSGB01``) are written by this package's byte-compatible
``io/serializer.py``, so files cross-load between the packages.

One tree per round on the device, eager; ``DMLC_TPU_SPARSE_ROUNDS_PER_
DISPATCH`` rounds (default 8) run between host fetches of their packed
trees, as the JAX package's rounds per dispatch.  A tree's fixed-point
scales (one device sync) come from its rows' ``g·w``/``h·w``, so the card
and the CPU write the same file.  Row subsampling draws the JAX package's
numpy masks: ``default_rng(seed)`` in one process, ``default_rng([seed,
rank])`` per rank.  Data parallel (one process per card, each with its own
rows): ``F`` by a host max all-reduce, the cut candidates allgathered and
merged, and every level's int64 histograms and node totals summed by a
device all-reduce before the split scan, so N ranks grow the 1-process
trees.  The JAX package's compile cache and ahead-of-time round program
have no counterpart: nothing is compiled.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ, LOG
from dmlc_core_tpu_torch.base.parameter import get_env
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.models.gbt_objectives import (OBJECTIVES,
                                                       fold_scale_pos_weight)
from dmlc_core_tpu_torch.models.gbt_split import _maybe_l1, gbt_metrics
from dmlc_core_tpu_torch.models.histgbt import HistGBTParam
from dmlc_core_tpu_torch.ops.histogram import hist_scales
from dmlc_core_tpu_torch.ops.sparse_hist import (
    EntryIndex, SparseCuts, _dq, _level_histogram_q, _node_totals_q,
    bin_sparse_entries, build_sparse_cuts, csr_rows, cuts_from_ptr,
    merge_sparse_cut_candidates, quantize_rows, route_sorted,
    sparse_best_split, sparse_cut_candidates)
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["SparseHistGBT"]

#: rounds between host fetches of the packed trees (the JAX package's
#: rounds per dispatch; this package's own knob)
ROUNDS_KNOB = "DMLC_TPU_SPARSE_ROUNDS_PER_DISPATCH"

#: ``torch.profiler`` labels of a round's three device groups
PROFILE_GROUPS = ("sparse.histogram", "sparse.route", "sparse.split")


def _leaf_update(preds: torch.Tensor, node: torch.Tensor,
                 leaf: torch.Tensor) -> torch.Tensor:
    return preds + leaf[torch.clamp(node, 0, leaf.shape[0] - 1).long()]


def _predict_sparse(margin, index: EntryIndex, feats, thrs, dirs, leafs,
                    bin_ptr_d, *, depth: int):
    """The stacked trees' leaves added to ``margin`` in tree order (the
    JAX package's scan), each tree routed level by level."""
    for t in range(feats.shape[0]):
        node = torch.zeros(margin.shape[0], dtype=torch.int32,
                           device=margin.device)
        for level in range(depth):
            nn = 1 << level
            node = route_sorted(index, node, feats[t, level, :nn],
                                thrs[t, level, :nn], dirs[t, level, :nn],
                                bin_ptr_d)
        margin = _leaf_update(margin, node, leafs[t])
    return margin


def _entry_rows(offset: np.ndarray, device: torch.device) -> torch.Tensor:
    """``csr_rows(offset)`` as int64 on ``device``, expanded there."""
    counts = torch.from_numpy(np.diff(offset)).to(device)
    return torch.repeat_interleave(
        torch.arange(len(counts), device=device), counts)


def _pack_tree(feats, thrs, dirs, gains, leaf, *, half: int
               ) -> torch.Tensor:
    """One flat f32 tensor per tree (the JAX package's layout: feat, thr,
    dir, gain per level padded to ``half``, then the leaves), so a chunk's
    trees come to the host in one fetch."""
    def cat(parts):
        return torch.cat([torch.nn.functional.pad(
            p.to(torch.float32), (0, half - p.shape[0])) for p in parts])
    return torch.cat([cat(feats), cat(thrs), cat(dirs), cat(gains), leaf])


def _sparse_round_core(row_e, gb_e, g, h, bin_ptr_d, feat_of_bin_d,
                       last_mask, *, index: EntryIndex, depth: int,
                       total_bins: int, lam: float, gamma: float, mcw: float,
                       alpha: float, eta: float,
                       n_global: Optional[int] = None,
                       reduce_fn: Optional[Callable] = None,
                       reduce_max: Optional[Callable] = None):
    """Grow one tree: per level route → left-child histograms (the right
    child by parent − left, exact in int64) → node totals → split scan;
    then the final route and the leaves ``−G/(H+λ)·η``.  ``index`` is the
    entries' :class:`~dmlc_core_tpu_torch.ops.sparse_hist.EntryIndex`
    (routing); ``row_e``/``gb_e`` feed the histograms.

    ``reduce_fn`` sums every int64 histogram and node total over ranks
    (``device_allreduce``; the identity in one process), ``reduce_max``
    takes the global max of the scales' statistics and ``n_global`` is
    the global row count, so every rank grows the 1-process tree.
    Returns (packed tree, each row's leaf, the leaf values)."""
    rf = reduce_fn or (lambda x: x)
    n = g.shape[0]
    n_leaf = 1 << depth
    half = max(n_leaf >> 1, 1)
    kg, kh = hist_scales(g, h, n=n_global, reduce_max=reduce_max)
    qf = quantize_rows(g, h, kg, kh).to(torch.float64)
    node = torch.zeros(n, dtype=torch.int32, device=g.device)
    feats, thrs, dirs, gains = [], [], [], []
    prev_full = None
    feat = thr = dirv = None
    for level in range(depth):
        n_nodes = 1 << level
        n_build = 1 if level == 0 else n_nodes >> 1
        if level > 0:
            with torch.profiler.record_function("sparse.route"):
                node = route_sorted(index, node, feat, thr, dirv, bin_ptr_d)
        with torch.profiler.record_function("sparse.histogram"):
            left = rf(_level_histogram_q(row_e, gb_e, node, qf, n_build,
                                         total_bins, level))
            if level == 0:
                full = left
            else:
                full = torch.stack([left, prev_full - left], dim=2).reshape(
                    2, n_nodes, total_bins)
            prev_full = full
            totals = rf(_node_totals_q(node, qf, n_nodes))
        with torch.profiler.record_function("sparse.split"):
            feat, thr, dirv, gain = sparse_best_split(
                full, totals, bin_ptr_d, feat_of_bin_d, last_mask, kg=kg,
                kh=kh, lam=lam, gamma=gamma, mcw=mcw, alpha=alpha)
        feats.append(feat)
        thrs.append(thr)
        dirs.append(dirv)
        gains.append(gain)
    with torch.profiler.record_function("sparse.route"):
        node = route_sorted(index, node, feat, thr, dirv, bin_ptr_d)
    with torch.profiler.record_function("sparse.histogram"):
        lt = rf(_node_totals_q(node, qf, n_leaf))
    leaf = (-_maybe_l1(_dq(lt[0], kg), alpha)
            / (_dq(lt[1], kh) + lam) * eta).to(torch.float32)
    return _pack_tree(feats, thrs, dirs, gains, leaf, half=half), node, leaf


class SparseHistGBT:
    """Sparsity-aware boosting over CSR input.

    :meth:`fit`/:meth:`predict` take raw ``offset/index/value`` arrays;
    :meth:`fit_block`/:meth:`predict_block` accept a
    :class:`~dmlc_core_tpu_torch.data.row_block.RowBlock`.  ``device`` is
    ``"cuda"`` (the default; raises without a GPU) or ``"cpu"``."""

    _MODEL_MAGIC = b"DCTSGB01"

    def __init__(self, param: Optional[HistGBTParam] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs: Any):
        self.param = param or HistGBTParam()
        if kwargs:
            self.param.init(kwargs)
        self.device = resolve_device(device)
        p = self.param
        CHECK(p.objective in ("binary:logistic", "reg:squarederror"),
              f"SparseHistGBT supports binary:logistic/reg:squarederror "
              f"(got {p.objective!r}); use HistGBT for the rest")
        CHECK(not (p.monotone_constraints
                   and any(int(v) for v in p.monotone_constraints)),
              "SparseHistGBT: monotone constraints not supported")
        CHECK(p.colsample_bytree >= 1.0,
              "SparseHistGBT: colsample_bytree not supported (v1) — "
              "a silently ignored knob would train a different model")
        # the field bound is inclusive; 0.0 would silently train
        # all-degenerate trees (same guard as the dense engine)
        CHECK(p.subsample > 0.0, "subsample must be > 0")
        self._obj = OBJECTIVES[p.objective]
        self.cuts: Optional[SparseCuts] = None
        self.n_features: int = 0
        self.trees: List[Dict[str, np.ndarray]] = []
        self.last_fit_seconds: Optional[float] = None
        #: the last fit's host set-up (cuts, entry binning, upload) in
        #: seconds, inside last_fit_seconds
        self.last_setup_seconds: Optional[float] = None
        self._train_margin: Optional[torch.Tensor] = None

    # -- input plumbing -------------------------------------------------
    @staticmethod
    def _csr(offset, index, value):
        offset = np.ascontiguousarray(offset, np.int64)
        index = np.ascontiguousarray(index, np.int64)
        value = (np.ones(len(index), np.float32) if value is None
                 else np.ascontiguousarray(value, np.float32))
        CHECK_EQ(len(index), len(value), "index/value length mismatch")
        CHECK_EQ(int(offset[-1]), len(index), "offset[-1] != nnz")
        CHECK(len(index) == 0 or int(index.min()) >= 0,
              "negative feature indices — they would wrap through "
              "numpy indexing into the LAST feature's bins and score "
              "silently wrong")
        CHECK(np.isfinite(value).all(),
              "sparse values must be finite — absent entries ARE the "
              "missing mass; an explicit NaN would silently bin as the "
              "feature's largest value, not route by the learned "
              "direction")
        # routing relies on at most ONE entry per (row, feature):
        # duplicates would sum their side verdicts and route the row to
        # an invalid node id
        if len(index):
            rows = csr_rows(offset)
            if (np.diff(index)[rows[1:] == rows[:-1]] > 0).all():
                # each row's features strictly increase: no duplicate
                return offset, index, value
            order = np.lexsort((index, rows))
            dup = ((rows[order][1:] == rows[order][:-1])
                   & (index[order][1:] == index[order][:-1]))
            CHECK(not dup.any(),
                  "duplicate (row, feature) entries in CSR input — "
                  "sum or drop duplicates first")
        return offset, index, value

    def _cut_tables(self):
        """The cuts' device tables: bin_ptr [F+1], feat_of_bin [TB] and
        each feature's last bin (not a threshold) as a mask [TB]."""
        c = self.cuts
        dev = self.device
        last = np.zeros(c.total_bins, bool)
        last[c.bin_ptr[1:] - 1] = True
        return (torch.from_numpy(c.bin_ptr).to(dev),
                torch.from_numpy(c.feat_of_bin.astype(np.int64)).to(dev),
                torch.from_numpy(last).to(dev))

    # -- training -------------------------------------------------------
    def fit(self, offset, index, value, y,
            weight: Optional[np.ndarray] = None,
            n_features: Optional[int] = None,
            cuts: Optional[SparseCuts] = None,
            distributed: Optional[bool] = None) -> "SparseHistGBT":
        """Boost ``n_trees`` rounds over CSR rows.

        ``n_features`` pins the feature-space width (else
        ``max(index)+1``).  ``cuts`` injects precomputed ragged cuts
        (else built from this input; distributed fits merge every
        worker's candidates).

        **Distributed** (auto when ``coll.world_size() > 1``;
        ``distributed=False`` forces a process-local fit inside a group):
        each worker holds its OWN row shard; the candidate matrix
        allgather merges global cuts, and per-level int64 histograms /
        node totals are all-reduced across workers, so all workers grow
        identical trees, the 1-process trees of the concatenated rows."""
        from dmlc_core_tpu_torch.parallel import collectives as coll

        p = self.param
        t0 = get_time()
        offset, index, value = self._csr(offset, index, value)
        y = np.ascontiguousarray(y, np.float32)
        n = len(offset) - 1
        CHECK_EQ(len(y), n, "y/offset row mismatch")
        weight = fold_scale_pos_weight(p, y, weight)  # spw ≡ inst weight
        F = int(n_features or (index.max() + 1 if len(index) else 1))
        if distributed is None:
            distributed = coll.world_size() > 1
        if distributed:
            # shards can disagree on the max feature id; cuts, bins and
            # histograms need ONE global F
            F = int(coll.allreduce(np.asarray([F], np.int64),
                                   op="max")[0])
        CHECK(len(index) == 0 or int(index.max()) < F,
              "n_features smaller than max feature index")
        CHECK(F <= 1 << 24,
              "n_features > 2^24: the packed-tree fetch rides f32 "
              "(exact only to 16,777,216) — split feature ids beyond "
              "that would silently corrupt.  Hash into <= 2^24 buckets")
        self.n_features = F

        dev = self.device
        index_d = torch.from_numpy(index).to(dev)
        value_d = torch.from_numpy(value).to(dev)
        if cuts is not None:
            CHECK_EQ(cuts.n_features, F,
                     "injected cuts' feature count != n_features")
            self.cuts = cuts
        elif distributed:
            msg_mb = F * (p.n_bins - 1) * 4 >> 20
            if msg_mb > 256:
                LOG("WARNING", "distributed sparse cuts: the [F, "
                    "n_bins-1] candidate allgather is %d MB/worker at "
                    "F=%d — drop n_bins (sparse features rarely need "
                    "256) or precompute cuts= once and inject them",
                    msg_mb, F)
            cand = sparse_cut_candidates(index_d, value_d, F, p.n_bins,
                                         dev)
            self.cuts = merge_sparse_cut_candidates(
                np.asarray(coll.allgather(cand)))            # [W, F, nb]
        else:
            self.cuts = build_sparse_cuts(index_d, value_d, F, p.n_bins,
                                          dev)
        TB = self.cuts.total_bins
        LOG("INFO", "SparseHistGBT: %d rows x %d features, %d nnz "
            "(density %.4f), %d ragged bins (dense would be %d)",
            n, F, len(index), len(index) / max(n * F, 1), TB,
            F * p.n_bins)

        bin_ptr_d, feat_of_bin_d, last_mask = self._cut_tables()
        y_d = torch.from_numpy(y).to(dev)
        w_d = (torch.ones(n, dtype=torch.float32, device=dev)
               if weight is None else
               torch.from_numpy(np.asarray(weight, np.float32)).to(dev))
        preds = torch.full((n,), p.base_score, dtype=torch.float32,
                           device=dev)
        gb_e = bin_sparse_entries(index_d, value_d, self.cuts, dev)
        del index_d, value_d
        row_e = _entry_rows(offset, dev)
        entries = EntryIndex(row_e, feat_of_bin_d[gb_e], gb_e, F)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.last_setup_seconds = get_time() - t0

        depth = p.max_depth
        half = max((1 << depth) >> 1, 1)
        d = depth * half
        self.trees = []
        cfg = dict(depth=depth, total_bins=TB, lam=p.reg_lambda,
                   gamma=p.gamma, mcw=p.min_child_weight, alpha=p.reg_alpha,
                   eta=p.learning_rate, index=entries)
        if distributed:
            n_global = int(coll.allreduce(np.asarray([n], np.int64))[0])
            cfg.update(n_global=n_global,
                       reduce_fn=coll.device_allreduce,
                       reduce_max=lambda x: coll.device_allreduce(
                           x, op="max"))

        def unpack(flats: torch.Tensor) -> None:
            for flat in flats.cpu().numpy():
                self.trees.append({
                    "feat": flat[:d].astype(np.int32).reshape(depth, half),
                    "thr": flat[d:2 * d].astype(np.int32).reshape(depth,
                                                                  half),
                    "dir": flat[2 * d:3 * d].astype(bool).reshape(depth,
                                                                  half),
                    "gain": flat[3 * d:4 * d].reshape(depth, half),
                    "leaf": flat[4 * d:],
                })

        def one_round(preds, wk):
            g, h = self._obj.grad_hess(preds, y_d)
            flat, node, leaf = _sparse_round_core(
                row_e, gb_e, g * wk, h * wk, bin_ptr_d, feat_of_bin_d,
                last_mask, **cfg)
            return _leaf_update(preds, node, leaf), flat

        if distributed or p.subsample < 1.0:
            # per-round host draws (reproducible numpy streams: the
            # process's, or each rank's own on its shard), each tree
            # fetched as it is grown
            rng = np.random.default_rng(
                [p.seed, coll.rank()] if distributed else p.seed)
            for _ in range(p.n_trees):
                wk = w_d
                if p.subsample < 1.0:
                    keep = (rng.random(n) < p.subsample).astype(np.float32)
                    wk = w_d * torch.from_numpy(keep).to(dev)
                preds, flat = one_round(preds, wk)
                unpack(flat[None])
        else:
            # K rounds between host fetches; the [K, L] packed trees come
            # back in one copy
            K = int(get_env(ROUNDS_KNOB, 8, int))
            CHECK(K >= 1, f"{ROUNDS_KNOB} must be >= 1, got {K}")
            done = 0
            while done < p.n_trees:
                k = min(K, p.n_trees - done)
                flats = []
                for _ in range(k):
                    preds, flat = one_round(preds, w_d)
                    flats.append(flat)
                unpack(torch.stack(flats))
                done += k
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.last_fit_seconds = get_time() - t0
        if _metrics.enabled() and p.n_trees:
            m = gbt_metrics()
            m["rounds"].inc(p.n_trees, engine="sparse")
            m["trees"].inc(p.n_trees, engine="sparse")
            m["phase"].observe(self.last_fit_seconds / p.n_trees,
                               engine="sparse", phase="round")
        self._train_margin = preds
        return self

    def fit_block(self, block, y=None, weight: Optional[np.ndarray] = None,
                  n_features: Optional[int] = None,
                  cuts: Optional[SparseCuts] = None,
                  distributed: Optional[bool] = None) -> "SparseHistGBT":
        """Train from a :class:`RowBlock` (labels/weights from the block
        unless overridden; ``cuts``/``distributed`` forward to
        :meth:`fit`)."""
        return self.fit(block.offset, block.index, block.value,
                        block.label if y is None else y,
                        weight=block.weight if weight is None else weight,
                        n_features=n_features, cuts=cuts,
                        distributed=distributed)

    # -- inference ------------------------------------------------------
    def predict_block(self, block, **kw) -> np.ndarray:
        """Score a :class:`RowBlock` (see :meth:`predict`)."""
        return self.predict(block.offset, block.index, block.value, **kw)

    def predict(self, offset, index, value,
                output_margin: bool = False,
                n_trees: Optional[int] = None) -> np.ndarray:
        """Score CSR rows with the trained ensemble (absent = missing,
        routed by each node's learned direction)."""
        CHECK(self.cuts is not None and self.trees, "predict before fit")
        offset, index, value = self._csr(offset, index, value)
        # entries with feature ids beyond the TRAINING space carry no
        # split information: they are absent to the model
        known = index < self.n_features
        n = len(offset) - 1
        dev = self.device
        if known.all():
            row_e = _entry_rows(offset, dev)
        else:
            row_e = torch.from_numpy(csr_rows(offset)[known].astype(
                np.int64)).to(dev)
            index, value = index[known], value[known]
        gb_e = bin_sparse_entries(index, value, self.cuts, dev)
        bin_ptr_d, feat_of_bin_d, _ = self._cut_tables()
        entries = EntryIndex(row_e, feat_of_bin_d[gb_e], gb_e,
                             self.n_features)
        margin = torch.full((n,), self.param.base_score,
                            dtype=torch.float32, device=dev)
        T = len(self.trees) if n_trees is None else min(n_trees,
                                                       len(self.trees))
        trees = self.trees[:T]

        def stack(key):
            return torch.from_numpy(np.stack([t[key] for t in trees])).to(dev)

        margin = _predict_sparse(
            margin, entries, stack("feat"), stack("thr"), stack("dir"),
            stack("leaf"), bin_ptr_d, depth=self.param.max_depth)
        if not output_margin:
            margin = self._obj.transform(margin)
        return margin.cpu().numpy()

    # -- introspection --------------------------------------------------
    def feature_importances(self, importance_type: str = "weight"
                            ) -> np.ndarray:
        """Per-feature importance over the ensemble (``"weight"`` =
        count of real splits, ``"gain"`` = total split gain — XGBoost's
        notions).  Degenerate/padding slots carry gain 0, so ``gain > 0``
        identifies genuine splits."""
        CHECK(len(self.trees) > 0, "no trees trained")
        CHECK(importance_type in ("weight", "gain"),
              f"unsupported importance_type {importance_type!r}")
        out = np.zeros(self.n_features,
                       np.float64 if importance_type == "gain"
                       else np.int64)
        for tree in self.trees:
            for level in range(tree["feat"].shape[0]):
                nn = 1 << level
                feat = tree["feat"][level][:nn]
                gain = tree["gain"][level][:nn]
                real = gain > 0
                if importance_type == "weight":
                    out += np.bincount(feat[real],
                                       minlength=self.n_features)
                else:
                    np.add.at(out, feat[real], gain[real])
        return out

    # -- persistence ----------------------------------------------------
    def save_model(self, uri: str) -> None:
        """Params + ragged cuts + trees to any Stream URI (the JAX
        package's ``DCTSGB01`` file, byte for byte)."""
        from dmlc_core_tpu_torch.io.serializer import write_obj
        from dmlc_core_tpu_torch.io.stream import Stream

        CHECK(self.cuts is not None and len(self.trees) > 0,
              "save_model before fit")
        s = Stream.create(uri, "w")
        try:
            s.write(self._MODEL_MAGIC)
            write_obj(s, {
                "param": self.param.to_dict(),
                "n_features": self.n_features,
                "cut_vals": self.cuts.cut_vals,
                "cut_ptr": self.cuts.cut_ptr,
                "trees": self.trees,
            })
        finally:
            s.close()

    @classmethod
    def load_model(cls, uri: str,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "SparseHistGBT":
        """Inverse of :meth:`save_model`; reads either package's files."""
        from dmlc_core_tpu_torch.io.serializer import read_obj
        from dmlc_core_tpu_torch.io.stream import Stream

        s = Stream.create(uri, "r")
        try:
            magic = s.read(len(cls._MODEL_MAGIC))
            CHECK_EQ(bytes(magic), cls._MODEL_MAGIC,
                     f"not a SparseHistGBT model: {uri}")
            payload = read_obj(s)
        finally:
            s.close()
        model = cls(device=device)
        model.param.init(payload["param"])
        model._obj = OBJECTIVES[model.param.objective]
        model.n_features = int(payload["n_features"])
        model.cuts = cuts_from_ptr(payload["cut_vals"], payload["cut_ptr"])
        model.trees = [dict(t) for t in payload["trees"]]
        return model
