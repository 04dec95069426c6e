"""Base layer: logging/CHECK/Error, timer, env, registry, parameter,
config, thread-local store, metrics (own copies of the JAX package's).
Reference: include/dmlc/{logging,timer,parameter,registry,config,
thread_local}.h (see SURVEY.md §2a); the metrics registry is this
framework's own (the reference has none — SURVEY.md §5)."""

from dmlc_core_tpu_torch.base.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from dmlc_core_tpu_torch.base.resilience import (  # noqa: F401
    CircuitBreaker,
    CircuitOpenError,
    RetryPolicy,
)
from dmlc_core_tpu_torch.base.thread_local import ThreadLocalStore  # noqa: F401
