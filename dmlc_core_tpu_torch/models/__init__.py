"""Models: histogram gradient-boosted trees (dense and sparse), the
linear booster, factorization machines, the BERT masked-LM trainer, the
ResNet image trainer over RecordIO image records, and
the sklearn-style wrappers (``GBTClassifier``, ``GBTRegressor``,
``GBTRanker``; loaded on first use, as in the JAX package)."""

from dmlc_core_tpu_torch.models.bert import BERT, BERTParam
from dmlc_core_tpu_torch.models.fm import FM, FMParam
from dmlc_core_tpu_torch.models.histgbt import HistGBT, HistGBTParam
from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT
from dmlc_core_tpu_torch.models.linear import GBLinear, GBLinearParam
from dmlc_core_tpu_torch.models.resnet import ResNet, ResNetParam, ResNetTrainer

__all__ = ["BERT", "BERTParam", "FM", "FMParam", "GBLinear",
           "GBLinearParam", "HistGBT", "HistGBTParam", "ResNet", "ResNetParam",
           "ResNetTrainer", "SparseHistGBT"]

_SKLEARN_WRAPPERS = ("GBTClassifier", "GBTRegressor", "GBTRanker")


def __getattr__(name):
    # lazy: models.sklearn imports scikit-learn when it is installed —
    # paths that never touch the wrappers must not pay for it
    if name in _SKLEARN_WRAPPERS:
        from dmlc_core_tpu_torch.models import sklearn as _sk

        return getattr(_sk, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
