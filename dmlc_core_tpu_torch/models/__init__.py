"""Models: histogram gradient-boosted trees and the BERT masked-LM
trainer."""

from dmlc_core_tpu_torch.models.bert import BERT, BERTParam
from dmlc_core_tpu_torch.models.histgbt import HistGBT, HistGBTParam

__all__ = ["BERT", "BERTParam", "HistGBT", "HistGBTParam"]
