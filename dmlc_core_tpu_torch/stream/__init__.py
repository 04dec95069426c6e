"""Streaming / online learning: the continuous train→serve loop (the
PyTorch port's counterpart of ``dmlc_core_tpu/stream``).

* :mod:`dataset` — one streaming :class:`Dataset` abstraction over the
  data plane, plus the dense event codec.
* :mod:`tail` — :class:`RecordIOTailer`: follow a growing append-only
  RecordIO shard set (torn tails held back, resync past corruption,
  jittered idle backoff, a crash-safe cursor through
  ``parallel.checkpoint``).
* :mod:`trainer` — :class:`OnlineTrainer`: warm-start-boost the existing
  ``HistGBT`` ensemble on fresh chunks (sliding window, ``decay^age``
  sample weights) on the model's device.
* :mod:`publisher` — :class:`ModelPublisher`: snapshot each refresh,
  stage it into ``serve.ModelRegistry``, gate it on a holdout window and
  activate it, or roll back on regression.

``python -m dmlc_core_tpu_torch.bench --stream`` measures staleness
(event appended → servable prediction).
"""

from dmlc_core_tpu_torch.stream.dataset import (Dataset,  # noqa: F401
                                                decode_dense_events,
                                                encode_dense_event,
                                                encode_dense_events)
from dmlc_core_tpu_torch.stream.publisher import ModelPublisher  # noqa: F401
from dmlc_core_tpu_torch.stream.tail import (RecordIOTailer,  # noqa: F401
                                             TailCursor)
from dmlc_core_tpu_torch.stream.trainer import OnlineTrainer  # noqa: F401

__all__ = [
    "Dataset", "RecordIOTailer", "TailCursor", "OnlineTrainer",
    "ModelPublisher", "encode_dense_event", "encode_dense_events",
    "decode_dense_events",
]
