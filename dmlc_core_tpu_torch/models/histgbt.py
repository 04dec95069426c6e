"""Histogram gradient-boosted trees on one GPU (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/histgbt.py`` for its flagship
path: dense, in-core, depth-wise ``HistGBT`` training
(``binary:logistic`` / ``reg:squarederror``), prediction, and
``save_model`` / ``load_model`` in the same file format.

One device, eager: the round is a Python loop over trees and levels in
the JAX program's level order —

* quantile cuts and binning on the device (``ops.quantile``), giving the
  feature-major uint8 ``[F, n]`` bin matrix;
* per tree: grad/hess, then level 0 ``build_histogram`` over all rows,
  each deeper level one ``fused_round`` (descend + left-child histograms
  + sibling subtraction) with the split tables of the level above, split
  scoring on the emitted histograms, a final descend, leaf values
  ``−G/(H+λ)·η`` and ``preds += leaf[node]``.

Trees are the JAX package's per-tree numpy arrays (``feat``, ``thr``,
``gain`` ``[depth, 2^(depth-1)]``, ``leaf`` ``[2^depth]``), so model files
and their consumers are unchanged.  Not ported yet: loss-guide growth, bin
packing and feature bundling, NaN-as-missing, monotone constraints,
multiclass and ranking objectives, row/column sampling, eval sets and
early stopping, continued training, external memory, multi-GPU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ, log_fatal
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.models.gbt_objectives import (
    EVAL_METRIC_NAMES, OBJECTIVE_NAMES, OBJECTIVES, fold_scale_pos_weight)
from dmlc_core_tpu_torch.models.gbt_split import (_advance_node,
                                                  _make_best_split, _maybe_l1)
from dmlc_core_tpu_torch.ops.histogram import (build_histogram, fused_round,
                                               hist_scales)
from dmlc_core_tpu_torch.ops.quantile import apply_bins, compute_cuts
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["HistGBT", "HistGBTParam"]


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
    """Train/predict API on one device.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``; the CPU runs the
    plain PyTorch versions of the kernels.  With no GPU present the
    default raises rather than running on the CPU."""

    _MODEL_MAGIC = b"DCTGBT01"
    #: rows per device batch in predict (bounds the transient f32 X and
    #: bin matrices on the device)
    _PREDICT_BATCH = 2_000_000

    def __init__(self, param: Optional[HistGBTParam] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs: Any):
        self.param = param or HistGBTParam()
        if kwargs:
            self.param.init(kwargs)
        self.device = resolve_device(device)
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
        feature-major uint8 ``[F, n]`` bin matrix, labels and weights on
        the device.  Sets ``self.cuts`` if unset."""
        p = self.param
        t0 = time.perf_counter()
        X = np.ascontiguousarray(X, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float32)
        n, F = X.shape
        CHECK_EQ(len(y), n, "X/y row mismatch")
        if np.isnan(X).any():
            log_fatal("X contains NaN: NaN-as-missing is not ported yet "
                      "(impute, or train with the JAX package)")
        weight = fold_scale_pos_weight(p, y, weight)
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
        bins_t = apply_bins(X_d, self.cuts)
        del X_d
        dd = {
            "bins_t": bins_t,
            "y_d": torch.from_numpy(y).to(self.device),
            "w_d": (torch.ones(n, dtype=torch.float32, device=self.device)
                    if w_d is None else w_d),
            "n": n,
            "n_features": F,
        }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_bin_seconds = time.perf_counter() - t0
        return dd

    def fit_device(self, dd: Dict[str, Any]) -> "HistGBT":
        """Boost ``n_trees`` rounds over a :meth:`make_device_data`
        handle; appends to ``self.trees``, sets ``last_fit_seconds``."""
        self._check_fit_params()
        p = self.param
        bins_t, y_d, w_d = dd["bins_t"], dd["y_d"], dd["w_d"]
        CHECK(bins_t.dtype == torch.uint8, "n_bins > 256 is not supported")
        preds = torch.full((dd["n"],), p.base_score, dtype=torch.float32,
                           device=self.device)
        self.last_tree_times = []
        t0 = time.perf_counter()
        for _ in range(p.n_trees):
            g, h = self._obj.grad_hess(preds, y_d)
            g = g * w_d
            h = h * w_d
            tree, delta = self._grow_tree(bins_t, g, h)
            preds = preds + delta
            # the copy to the host waits for the tree, so the timestamp
            # marks when its device work finished
            self.trees.append({k: tree[k].cpu().numpy() for k in _TREE_KEYS})
            self.last_tree_times.append(time.perf_counter() - t0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_fit_seconds = time.perf_counter() - t0
        self._train_preds = preds
        return self

    def _grow_tree(self, bins_t: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One depth-wise tree on (g, h) → (tree arrays, margin delta).

        Level 0 builds the root histogram over all rows; every deeper
        level is one fused round: rows descend by the level above's split
        tables, only LEFT children get a built histogram, the right child
        is parent − left.  All levels share one fixed-point scale pair,
        so every histogram's bytes are independent of summation order."""
        p = self.param
        depth, B = p.max_depth, p.n_bins
        lam, alpha = p.reg_lambda, p.reg_alpha
        half = max((1 << depth) >> 1, 1)
        best_split = _make_best_split(B, lam, p.gamma, p.min_child_weight,
                                      alpha=alpha)
        best_split_leaf = _make_best_split(B, lam, p.gamma,
                                           p.min_child_weight,
                                           with_child_sums=True, alpha=alpha)
        scales = hist_scales(g, h)
        node = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                           device=bins_t.device)
        feats, thrs, gains = [], [], []
        prev_hist = feat = thr = gsum = hsum = None
        for level in range(depth):
            n_nodes = 1 << level
            score_fn = best_split_leaf if level == depth - 1 else best_split
            if level == 0:
                hist = build_histogram(bins_t, node, g, h, 1, B,
                                       scales=scales)
                scores = score_fn(hist)
            else:
                node, hist, scores = fused_round(
                    bins_t, node, feat, thr, g, h, prev_hist, n_nodes >> 1,
                    B, score_fn=score_fn, by_node=True, scales=scales)
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
        leaf_node = _advance_node(bins_t, node, feat, thr)
        leaf_w = -_maybe_l1(gsum, alpha) / (hsum + lam)
        leaf = leaf_w * p.learning_rate
        tree = {"feat": torch.stack(feats), "thr": torch.stack(thrs),
                "gain": torch.stack(gains), "leaf": leaf}
        return tree, leaf[leaf_node]

    def train_margins(self) -> np.ndarray:
        """Raw training-set margins after :meth:`fit`."""
        CHECK(self._train_preds is not None, "call fit first")
        return self._train_preds.cpu().numpy()

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
