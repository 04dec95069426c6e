"""scikit-learn-style estimator wrappers (XGBClassifier-family analog).

XGBoost users reach its boosters through the sklearn API at least as
often as through the native one; these wrappers give HistGBT and
GBLinear the same ergonomic surface — ``fit(X, y)`` / ``predict`` /
``predict_proba`` / ``score`` / ``get_params`` / ``set_params`` — so
pipeline code written against ``XGBClassifier``/``XGBRegressor``/
``XGBRanker`` ports by changing the import.  ``booster='gbtree'``
selects hist-GBT, ``'gblinear'`` the linear booster, matching
XGBoost's knob.

No sklearn import is required (duck-typed estimator contract), but the
wrappers satisfy ``sklearn.base.BaseEstimator`` conventions (params in
``__init__`` signature order, ``get_params``/``set_params`` round-trip)
so they compose with sklearn Pipelines and model-selection utilities
when sklearn is present.

The PyTorch port's counterpart of ``dmlc_core_tpu/models/sklearn.py``,
over the port's ``HistGBT``, ``GBLinear`` and ``SparseHistGBT``.  The
wrappers take one more keyword, ``device``, passed through to the
booster: ``None`` (the default) runs on ``cuda`` and raises without a
GPU, ``"cpu"`` runs on the host.  Without scikit-learn installed the
bases are plain objects and everything but sklearn's own utilities
(pipelines, grid search) works.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.models.histgbt import HistGBT
from dmlc_core_tpu_torch.models.linear import GBLinear

try:  # real sklearn bases when present: __sklearn_tags__ etc. for
    # GridSearchCV/Pipeline (sklearn ≥1.6 requires the tags protocol);
    # plain-object fallback keeps the wrappers import-safe without it
    from sklearn.base import (BaseEstimator as _SkBase,
                              ClassifierMixin as _SkClf,
                              RegressorMixin as _SkReg)
except ImportError:  # plain objects: the wrappers need no sklearn
    class _SkBase:  # type: ignore[no-redef]
        pass

    class _SkClf:  # type: ignore[no-redef]
        pass

    class _SkReg:  # type: ignore[no-redef]
        pass

__all__ = ["GBTClassifier", "GBTRegressor", "GBTRanker"]


class _EstimatorBase(_SkBase):
    """Shared param plumbing + booster construction.

    ``get_params``/``set_params`` are overridden (not inherited):
    sklearn's introspection rejects ``**extra``, which we keep so any
    native booster knob (gamma, min_child_weight, …) passes through."""

    _objective: str = ""

    def __init__(self, booster: str = "gbtree", n_estimators: int = 100,
                 max_depth: int = 6, learning_rate: float = 0.3,
                 n_bins: int = 256, reg_lambda: float = 1.0,
                 reg_alpha: float = 0.0, subsample: float = 1.0,
                 colsample_bytree: float = 1.0, seed: int = 0,
                 device: Optional[str] = None, **extra: Any):
        CHECK(booster in ("gbtree", "gblinear"),
              f"booster must be gbtree|gblinear, got {booster!r}")
        self.booster = booster
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_bins = n_bins
        self.reg_lambda = reg_lambda
        self.reg_alpha = reg_alpha
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.seed = seed
        self.device = device
        self._extra = dict(extra)
        self._model = None

    #: the constructor's explicit keywords — the ONLY names set_params may
    #: setattr.  ``hasattr`` would also match methods and properties (a
    #: set_params(fit=...) must not clobber the bound method, and
    #: set_params(model=...) must not hit the setter-less property).
    _PARAM_NAMES = ("booster", "n_estimators", "max_depth", "learning_rate",
                    "n_bins", "reg_lambda", "reg_alpha", "subsample",
                    "colsample_bytree", "seed", "device")

    # -- sklearn estimator contract -------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        out = {k: getattr(self, k) for k in self._PARAM_NAMES}
        out.update(self._extra)
        return out

    def set_params(self, **params: Any) -> "_EstimatorBase":
        """Known names set attributes; anything else routes to the native
        booster's kwargs (``_extra``) — GridSearchCV over e.g. ``gamma``
        works — but is validated EAGERLY against the booster's Parameter
        schema so a typo raises here (sklearn's contract) instead of
        deep inside a later fit."""
        for k, v in params.items():
            if k in self._PARAM_NAMES:
                setattr(self, k, v)
            else:
                from dmlc_core_tpu_torch.models.histgbt import HistGBTParam
                from dmlc_core_tpu_torch.models.linear import GBLinearParam
                # booster Parameter fields plus the constructor-level
                # passthroughs (_make forwards _extra to the booster
                # __init__, which also takes mesh=)
                known = (set(HistGBTParam.fields())
                         | set(GBLinearParam.fields()) | {"mesh"})
                if k not in known:
                    raise ValueError(
                        f"Invalid parameter {k!r} for estimator "
                        f"{type(self).__name__}. Valid parameters: "
                        f"{sorted(set(self._PARAM_NAMES) | known)}")
                self._extra[k] = v
        return self

    # -- booster construction -------------------------------------------
    def _make(self, objective: str, num_class: int = 1):
        # re-validate here, not only in __init__: set_params (e.g. a
        # GridSearchCV grid) can change booster after construction
        CHECK(self.booster in ("gbtree", "gblinear"),
              f"booster must be gbtree|gblinear, got {self.booster!r}")
        if self.booster == "gblinear":
            CHECK(objective in ("binary:logistic", "reg:squarederror"),
                  f"gblinear supports binary/regression objectives, "
                  f"got {objective!r}")
            return GBLinear(n_rounds=self.n_estimators,
                            learning_rate=self.learning_rate,
                            reg_lambda=self.reg_lambda,
                            reg_alpha=self.reg_alpha,
                            objective=objective, device=self.device,
                            **self._extra)
        kw: Dict[str, Any] = dict(
            n_trees=self.n_estimators, max_depth=self.max_depth,
            learning_rate=self.learning_rate, n_bins=self.n_bins,
            reg_lambda=self.reg_lambda, reg_alpha=self.reg_alpha,
            subsample=self.subsample,
            colsample_bytree=self.colsample_bytree,
            objective=objective, seed=self.seed)
        if num_class > 1:
            kw["num_class"] = num_class
        kw.update(self._extra)
        return HistGBT(device=self.device, **kw)

    # -- scipy.sparse routing (XGBClassifier accepts sparse X) ----------
    @staticmethod
    def _is_scipy_sparse(X) -> bool:
        return hasattr(X, "tocsr") and not isinstance(X, np.ndarray)

    def _make_sparse(self, objective: str):
        from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT

        CHECK(self.booster == "gbtree",
              "sparse input needs the tree booster (densify for "
              "gblinear, or use GBLinear.fit_iter's CSR path)")
        kw: Dict[str, Any] = dict(
            n_trees=self.n_estimators, max_depth=self.max_depth,
            learning_rate=self.learning_rate, n_bins=self.n_bins,
            reg_lambda=self.reg_lambda, reg_alpha=self.reg_alpha,
            subsample=self.subsample,
            colsample_bytree=self.colsample_bytree,
            objective=objective, seed=self.seed)
        kw.update(self._extra)
        return SparseHistGBT(device=self.device, **kw)

    @staticmethod
    def _csr_canon(X):
        """scipy matrix → canonical CSR arrays (duplicates summed, the
        sparse engine's one-entry-per-(row, feature) contract).  The
        copy happens only when canonicalization would mutate the
        caller's matrix — the common csr_matrix(dense)/tocsr() case is
        already canonical and passes through zero-copy."""
        csr = X.tocsr()
        if not getattr(csr, "has_canonical_format", False):
            csr = csr.copy()
            csr.sum_duplicates()
        return csr.indptr, csr.indices, csr.data, csr.shape[1]

    def _fit_sparse(self, X, y_codes, objective, sample_weight, fit_kw):
        CHECK(not fit_kw,
              f"sparse input does not support {sorted(fit_kw)} "
              "(eval_set/early stopping need the dense engine — "
              "densify, or fit SparseHistGBT directly)")
        self._model = self._make_sparse(objective)
        indptr, indices, data, F = self._csr_canon(X)
        self._model.fit(indptr, indices, data, y_codes,
                        weight=sample_weight, n_features=F)
        return self

    def _predict_sparse_raw(self, X, **kw):
        indptr, indices, data, _ = self._csr_canon(X)
        return self._model.predict(indptr, indices, data, **kw)

    def _predict_native(self, X):
        """TRANSFORMED native-booster predictions (sigmoid probabilities
        for binary:logistic, values for regression — NOT raw margins:
        both paths run the objective's output transform), with
        SYMMETRIC input-type guards:
        a sparse-fit model requires sparse X (dense zeros would mean
        VALUES, not absence) and a dense-fit model requires dense X
        (np.asarray on a scipy matrix dies with an unrelated
        ValueError deep in the engine otherwise)."""
        from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT

        if isinstance(self.model, SparseHistGBT):
            CHECK(self._is_scipy_sparse(X),
                  "this model was fit on sparse input (absent ≡ "
                  "missing) — pass a scipy.sparse matrix; a dense "
                  "matrix's zeros would mean VALUES, not absence")
            return self._predict_sparse_raw(X)
        CHECK(not self._is_scipy_sparse(X),
              "this model was fit on dense input — densify with "
              "X.toarray(), or refit on the sparse matrix to get "
              "absent ≡ missing semantics")
        return self.model.predict(X)

    @property
    def model(self):
        """The underlying native booster (after fit)."""
        CHECK(self._model is not None, "call fit first")
        return self._model

    def _watch_eval_set(self, fit_kw: Dict[str, Any]) -> Dict[str, Any]:
        """Unwrap XGBoost's list-of-pairs ``eval_set``: the LAST pair is
        watched (early-stopping semantics) and its index recorded for
        :meth:`evals_result`'s key.  Shared by every wrapper fit."""
        ev = fit_kw.get("eval_set")
        self._watched_eval_idx = 0
        if isinstance(ev, list):
            CHECK(len(ev) > 0, "eval_set: empty list")
            # only unwrap the list-of-PAIRS form: a bare [Xv, yv] list
            # (tuple spelled as a list) must pass through as the single
            # pair it is, not be misread as two pairs
            if isinstance(ev[0], (tuple, list)):
                self._watched_eval_idx = len(ev) - 1
                fit_kw["eval_set"] = ev[-1]
        return fit_kw

    def evals_result(self) -> Dict[str, Dict[str, list]]:
        """XGBoost-shaped validation curve of the last ``eval_set`` fit
        (one point per dispatch chunk — XGBoost records per round; the
        x-axis is ``[r for r, _ in model.eval_history]``).

        Only the WATCHED pair is tracked (the last of the list form,
        like XGBoost's early stopping), and its curve is keyed by its
        position — ``validation_{n-1}`` for an n-pair list — so code
        expecting XGBoost's per-pair dict fails with a loud KeyError on
        the untracked pairs instead of silently misreading e.g. the
        validation curve as the training curve.

        Granularity differs from XGBoost: one point per *dispatch chunk*
        (the compiled multi-round step), not per boosting round, so
        ``len(curve) != n_estimators`` in general.  Every key of the
        returned per-dataset dict is a metric name (the XGBoost contract
        generic consumers iterate over); each point's boosting-round
        index lives on ``self.model.eval_history`` as ``(round, score)``
        pairs — use ``[r for r, _ in est.model.eval_history]`` as the
        x-axis (see ``doc/migration.md``)."""
        m = self.model
        name = getattr(m, "eval_metric_name", None)
        CHECK(name is not None,
              "evals_result: fit with eval_set= first (gbtree only)")
        key = f"validation_{getattr(self, '_watched_eval_idx', 0)}"
        return {key: {name: [s for _, s in m.eval_history]}}

    @property
    def feature_importances_(self) -> np.ndarray:
        """Normalized gain importances (XGBClassifier's default
        ``importance_type='gain'``, scaled to sum to 1 like sklearn's
        own ensembles).  gblinear models expose |weight| instead, the
        only importance a linear booster has."""
        m = self.model
        if self.booster == "gblinear":         # |w|: a linear model's
            imp = np.abs(np.asarray(m.weights, np.float64))  # only notion
        else:
            imp = np.asarray(m.feature_importances("gain"), np.float64)
        total = imp.sum()
        return (imp / total if total > 0 else imp).astype(np.float32)

    def apply(self, X: np.ndarray) -> np.ndarray:
        """Per-tree leaf indices ``[n, T]`` (multiclass: ``[n, T, K]``,
        matching ``predict_leaf``) — sklearn's ``apply`` / XGBoost's
        ``pred_leaf``, the GBDT feature-embedding hook.  gbtree only."""
        CHECK(self.booster == "gbtree",
              "apply() needs the tree booster (booster='gbtree')")
        CHECK(hasattr(self.model, "predict_leaf"),
              "apply() is not available for sparse-input models "
              "(SparseHistGBT has no predict_leaf yet)")
        return self.model.predict_leaf(X)

    def save_model(self, uri: str) -> None:
        self.model.save_model(uri)


class GBTClassifier(_SkClf, _EstimatorBase):
    """Classifier: binary or multiclass chosen from the label set
    (XGBClassifier semantics)."""

    def fit(self, X: np.ndarray, y: np.ndarray,
            sample_weight: Optional[np.ndarray] = None,
            **fit_kw: Any) -> "GBTClassifier":
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        n_class = len(self.classes_)
        CHECK(n_class >= 2, "need at least 2 classes")
        codes = np.searchsorted(self.classes_, y).astype(np.float32)
        if fit_kw.get("eval_set") is not None:
            # validation labels go through the SAME encoding as y.
            # XGBClassifier takes a LIST of (X, y) pairs and its early
            # stopping watches the LAST one (shared _watch_eval_set); a
            # bare (X, y) tuple is accepted too.  String or
            # non-contiguous labels would otherwise reach the booster
            # raw.
            fit_kw = self._watch_eval_set(fit_kw)
            Xv, yv = fit_kw["eval_set"]
            yv = np.asarray(yv)
            CHECK(np.isin(yv, self.classes_).all(),
                  "eval_set labels contain classes not present in y")
            fit_kw["eval_set"] = (
                Xv, np.searchsorted(self.classes_, yv).astype(np.float32))
        if self._is_scipy_sparse(X):
            # XGBClassifier's sparse-DMatrix surface: absent entries are
            # MISSING (sparsity-aware split finding) via SparseHistGBT
            CHECK(n_class == 2,
                  "sparse input supports binary classification "
                  "(SparseHistGBT has no multi:softmax) — densify for "
                  "multiclass")
            return self._fit_sparse(X, codes, "binary:logistic",
                                    sample_weight, fit_kw)
        if n_class == 2:
            self._model = self._make("binary:logistic")
        else:
            self._model = self._make("multi:softmax", num_class=n_class)
        self._model.fit(X, codes, weight=sample_weight, **fit_kw)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        raw = self._predict_native(X)
        if len(self.classes_) == 2:
            return self.classes_[(np.asarray(raw) > 0.5).astype(int)]
        return self.classes_[np.asarray(raw).astype(int)]

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT

        if self.booster == "gblinear" or isinstance(self.model,
                                                    SparseHistGBT):
            p1 = np.asarray(self._predict_native(X))
            return np.stack([1.0 - p1, p1], axis=1)
        return self.model.predict_proba(X)

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        """Mean accuracy (sklearn classifier convention)."""
        return float((self.predict(X) == np.asarray(y)).mean())


class GBTRegressor(_SkReg, _EstimatorBase):
    """Regressor (XGBRegressor analog, reg:squarederror)."""

    def fit(self, X: np.ndarray, y: np.ndarray,
            sample_weight: Optional[np.ndarray] = None,
            **fit_kw: Any) -> "GBTRegressor":
        if self._is_scipy_sparse(X):
            return self._fit_sparse(X, np.asarray(y, np.float32),
                                    "reg:squarederror", sample_weight,
                                    fit_kw)
        self._model = self._make("reg:squarederror")
        fit_kw = self._watch_eval_set(fit_kw)
        self._model.fit(X, np.asarray(y, np.float32),
                        weight=sample_weight, **fit_kw)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self._predict_native(X))

    def score(self, X: np.ndarray, y: np.ndarray) -> float:
        """R² (sklearn regressor convention)."""
        y = np.asarray(y, np.float64)
        resid = y - self.predict(X)
        denom = np.var(y) * len(y)
        return float(1.0 - (resid @ resid) / denom) if denom else 0.0


class GBTRanker(_EstimatorBase):
    """Learning-to-rank (XGBRanker analog) over qid groups.

    ``objective`` passes through like XGBRanker's: ``rank:pairwise``
    (default, RankNet), or the LambdaMART pair ``rank:ndcg`` /
    ``rank:map`` (lambdas weighted by |Δndcg| / |Δmap| of swapping the
    pair in the current ranking)."""

    def fit(self, X: np.ndarray, y: np.ndarray, *,
            qid: np.ndarray, **fit_kw: Any) -> "GBTRanker":
        CHECK(self.booster == "gbtree",
              "rank objectives need the tree booster")
        obj = self._extra.get("objective", "rank:pairwise")
        CHECK(obj.startswith("rank:"),
              f"GBTRanker objective must be rank:*, got {obj!r}")
        self._model = self._make(obj)
        self._model.fit(X, np.asarray(y, np.float32), qid=qid, **fit_kw)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self.model.predict(X))

    def score(self, X: np.ndarray, y: np.ndarray, *,
              qid: np.ndarray, k: Optional[int] = None) -> float:
        """Mean NDCG@k over queries."""
        from dmlc_core_tpu_torch.models.ranking import ndcg

        return ndcg(np.asarray(y), self.predict(X), np.asarray(qid), k=k)
