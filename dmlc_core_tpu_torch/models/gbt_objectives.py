"""GBT training objectives (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/gbt_objectives.py`` for the
objectives this package trains so far: ``binary:logistic`` and
``reg:squarederror``.  Every objective provides ``grad_hess`` (the
boosting step's inputs), ``transform`` (margin → prediction) and
``row_loss``/``metric``.  The multiclass and ranking objectives and the
eval-metric table are not ported yet; their names stay known so that
:class:`~dmlc_core_tpu_torch.models.histgbt.HistGBTParam` validates the
same values as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.base.registry import Registry

__all__ = ["OBJECTIVES", "OBJECTIVE_NAMES", "EVAL_METRIC_NAMES",
           "fold_scale_pos_weight"]

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
