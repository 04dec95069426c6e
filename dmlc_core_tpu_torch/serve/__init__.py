"""Dynamic micro-batching inference engine with versioned hot-swap.

The ROADMAP north star is a system "serving heavy traffic from millions
of users"; historically dmlc-core was the substrate UNDER served models
(XGBoost/MXNet deployments).  This package is that missing inference
path, layered on the substrate the repo already has:

* :mod:`runner` — :class:`ModelRunner`: any trained model (HistGBT /
  SparseHistGBT / GBLinear / FM / sklearn wrappers) behind a padded
  power-of-two batch-bucket executor, so live traffic's arbitrary
  request sizes hit at most ``log2(max_batch)+1`` compiled shapes.
* :mod:`batcher` — :class:`DynamicBatcher`: thread-safe request
  coalescing on :class:`~dmlc_core_tpu_torch.io.concurrency.
  ConcurrentBlockingQueue` — bounded queue with backpressure,
  size-or-deadline flush, per-request futures, timeout/cancel, graceful
  drain.
* :mod:`registry` — :class:`ModelRegistry`: versioned models over the
  ``parallel.checkpoint`` ``(version, state)`` contract, atomic
  hot-swap while in-flight batches finish on the old version.
* :mod:`frontend` — :class:`ServeFrontend`: stdlib-sockets HTTP/JSON
  (``/predict``, ``/healthz``, ``/metrics``) with 503 admission
  control and full ``base.metrics`` instrumentation.

Quick start (the JAX package's ``doc/serving.md`` describes the same API)::

    from dmlc_core_tpu_torch.serve import ModelRegistry, ServeFrontend

    registry = ModelRegistry(max_batch=256)
    registry.load("file:///models/gbt.ckpt")      # or .publish(model)
    with ServeFrontend(registry, port=8000) as fe:
        ...                                        # POST /predict
    registry.load("file:///models/gbt_v2.ckpt")    # hot-swap, zero drop

The PyTorch port's serving tier, with the JAX package's exports.  A
published model predicts on its own device (``ModelRegistry(device=)``
says where ``load`` puts a checkpoint's model: ``cuda`` by default).
Not ported yet: ``serve.tenancy`` and ``serve.fleet`` (ROADMAP item 12).
"""

from dmlc_core_tpu_torch.serve.batcher import (BatcherClosedError,  # noqa: F401
                                         DynamicBatcher, QueueFullError)
from dmlc_core_tpu_torch.serve.client import ResilientClient  # noqa: F401
from dmlc_core_tpu_torch.serve.frontend import (TENANT_HEADER,  # noqa: F401
                                          HttpServer, ServeFrontend)
from dmlc_core_tpu_torch.serve.instruments import serve_metrics  # noqa: F401
from dmlc_core_tpu_torch.serve.registry import (ModelRegistry,  # noqa: F401
                                          checkpoint_model, clone_model,
                                          load_model_checkpoint,
                                          model_from_bytes, model_to_bytes)
from dmlc_core_tpu_torch.serve.runner import ModelRunner  # noqa: F401

__all__ = [
    "ModelRunner", "DynamicBatcher", "QueueFullError",
    "BatcherClosedError", "ModelRegistry", "checkpoint_model",
    "clone_model", "load_model_checkpoint", "model_to_bytes",
    "model_from_bytes", "HttpServer", "ServeFrontend", "TENANT_HEADER",
    "ResilientClient", "serve_metrics",
]
