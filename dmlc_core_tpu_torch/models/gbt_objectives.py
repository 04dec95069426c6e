"""GBT training objectives (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/gbt_objectives.py`` for the
objectives this package trains: ``binary:logistic``, ``multi:softmax``
(margins ``[n, K]``) and ``reg:squarederror``.  Every objective provides
``grad_hess`` (the boosting step's inputs), ``transform`` (margin →
prediction) and ``row_loss``/``metric``.  :data:`EVAL_METRICS` holds the
validation metrics of these objectives (``logloss``, ``error``, ``auc``;
``mlogloss``, ``merror``; ``rmse``, ``mae``), each reduced in float64 and
rounded to one f32 value, so that the CPU and the GPU score alike.  The
ranking objectives are not ported; their names stay known so that
:class:`~dmlc_core_tpu_torch.models.histgbt.HistGBTParam` validates the
same values as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.registry import Registry

__all__ = ["OBJECTIVES", "OBJECTIVE_NAMES", "EVAL_METRIC_NAMES",
           "EVAL_METRICS", "fold_scale_pos_weight"]

OBJECTIVES: Registry = Registry.get("gbt_objective")

#: every objective name the JAX package accepts (HistGBTParam's enum)
OBJECTIVE_NAMES = ("binary:logistic", "reg:squarederror", "multi:softmax",
                   "rank:pairwise", "rank:ndcg", "rank:map")
#: the JAX package's eval-metric names (HistGBTParam's enum)
EVAL_METRIC_NAMES = ("auc", "error", "logloss", "mae", "merror", "mlogloss",
                     "rmse")


def _sigmoid(pred: torch.Tensor) -> torch.Tensor:
    """f32 sigmoid computed in f64 and rounded once, so that the CPU and
    the GPU give the same bits (their f32 ``exp`` differ in the last
    place; two correctly-near f64 results almost never round apart)."""
    return torch.sigmoid(pred.double()).float()


class _ObjectiveBase:
    """Shared plumbing: the metric is the mean of per-row losses."""

    @classmethod
    def metric(cls, pred, y):
        return torch.mean(cls.row_loss(pred, y))

    @classmethod
    def eval_loss(cls, pred, y):
        """:meth:`metric` as a validation score: the mean in float64,
        rounded to f32 (one value on any device)."""
        return cls.row_loss(pred, y).double().mean().float()


@OBJECTIVES.register("binary:logistic")
class _Logistic(_ObjectiveBase):
    """grad/hess of log loss on raw margins; transform = sigmoid."""

    @staticmethod
    def grad_hess(pred, y):
        p = _sigmoid(pred)
        return p - y, p * (1.0 - p)

    @staticmethod
    def transform(pred):
        return _sigmoid(pred)

    @staticmethod
    def row_loss(pred, y):  # per-row logloss
        p = _sigmoid(pred)
        eps = 1e-7
        return -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))


def _softmax(pred: torch.Tensor) -> torch.Tensor:
    """Row softmax of ``[n, K]`` f32 margins computed in f64 and rounded
    once, as :func:`_sigmoid`: the CPU and the GPU give the same bits."""
    return torch.softmax(pred.double(), dim=1).float()


@OBJECTIVES.register("multi:softmax")
class _Softmax(_ObjectiveBase):
    """K-class softmax (XGBoost ``multi:softmax``): margins ``[n, K]``,
    grad/hess per class from the full softmax row; ``transform`` gives the
    argmax class, :meth:`prob` the probability matrix."""

    @staticmethod
    def grad_hess(pred, y):                  # pred [n, K], y [n] labels
        prob = _softmax(pred)
        yoh = torch.nn.functional.one_hot(y.to(torch.int64),
                                          pred.shape[1]).to(pred.dtype)
        return prob - yoh, torch.clamp(2.0 * prob * (1.0 - prob), min=1e-6)

    @staticmethod
    def transform(pred):                     # class index
        return torch.argmax(pred, dim=1).to(torch.float32)

    @staticmethod
    def prob(pred):
        return _softmax(pred)

    @staticmethod
    def row_loss(pred, y):                   # mlogloss
        logp = torch.log_softmax(pred.double(), dim=1)
        return -torch.gather(logp, 1, y.to(torch.int64)[:, None])[:, 0].float()


@OBJECTIVES.register("reg:squarederror")
class _SquaredError(_ObjectiveBase):
    @staticmethod
    def grad_hess(pred, y):
        return pred - y, torch.ones_like(pred)

    @staticmethod
    def transform(pred):
        return pred

    @staticmethod
    def row_loss(pred, y):  # per-row squared error
        return (pred - y) ** 2

    @classmethod
    def metric(cls, pred, y):  # rmse = sqrt of the mean row loss
        return torch.sqrt(torch.mean(cls.row_loss(pred, y)))

    @classmethod
    def eval_loss(cls, pred, y):
        return torch.sqrt(cls.row_loss(pred, y).double().mean()).float()


def _metric_auc(margin, y):
    """ROC-AUC by the rank-sum identity with MIDRANKS for ties (a tree's
    margins tie heavily), 0.5 on a single-class set — the JAX package's
    ``_metric_auc``, its sums taken in float64 (exact on half-integer
    ranks), rounded to f32."""
    s = torch.sort(margin).values
    lo = torch.searchsorted(s, margin, right=False)
    hi = torch.searchsorted(s, margin, right=True)
    midrank = (lo + hi + 1).double() / 2.0          # 1-based midranks
    yd = y.double()
    npos = yd.sum()
    nneg = y.shape[0] - npos
    denom = npos * nneg
    auc = ((midrank * yd).sum() - npos * (npos + 1) / 2) / torch.where(
        denom > 0, denom, 1.0)
    return torch.where(denom > 0, auc, 0.5).float()


def _metric_error(margin, y):
    return ((_sigmoid(margin) > 0.5) != (y > 0.5)).double().mean().float()


def _metric_mae(margin, y):
    return (margin - y).abs().double().mean().float()


def _metric_merror(margin, y):
    return (torch.argmax(margin, dim=1) != y.to(torch.int64)
            ).double().mean().float()


#: eval_metric name → (fn(margin, y) -> f32 scalar tensor, maximize?)
EVAL_METRICS = {
    "logloss": (_Logistic.eval_loss, False),
    "error": (_metric_error, False),
    "auc": (_metric_auc, True),
    "rmse": (_SquaredError.eval_loss, False),
    "mae": (_metric_mae, False),
    "mlogloss": (_Softmax.eval_loss, False),
    "merror": (_metric_merror, False),
}

#: which metrics fit which objective's margins (the JAX package's table)
_METRICS_BY_OBJECTIVE = {
    "binary:logistic": {"logloss", "error", "auc"},
    "reg:squarederror": {"rmse", "mae"},
    "multi:softmax": {"mlogloss", "merror"},
    "rank:pairwise": set(),
    "rank:ndcg": set(),
    "rank:map": set(),
}


def fold_scale_pos_weight(param, y, weight):
    """Fold ``param.scale_pos_weight`` into the instance-weight vector
    (XGBoost: positives' grad AND hess scale by the factor — an instance
    weight).  Numpy in, numpy out, as in the JAX package."""
    if param.scale_pos_weight == 1.0:
        return weight
    CHECK(param.objective == "binary:logistic",
          f"scale_pos_weight only applies to binary:logistic "
          f"(objective is {param.objective!r})")
    spw = np.where(np.asarray(y) == 1.0,
                   np.float32(param.scale_pos_weight), np.float32(1.0))
    return spw if weight is None else np.asarray(weight, np.float32) * spw
