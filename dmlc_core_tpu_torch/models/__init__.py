"""Models: histogram gradient-boosted trees."""

from dmlc_core_tpu_torch.models.histgbt import HistGBT, HistGBTParam

__all__ = ["HistGBT", "HistGBTParam"]
