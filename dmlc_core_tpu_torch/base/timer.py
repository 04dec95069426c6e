"""Wall-clock timing.

Reference parity: ``include/dmlc/timer.h :: dmlc::GetTime()`` (SURVEY.md
§2a), extended, as ``dmlc_core_tpu.base.timer`` is, with a ``Timer``
context manager and a device-aware :func:`block_until_ready_time`: work
on a CUDA device is enqueued asynchronously, so a host clock around the
call alone measures the enqueue, not the work.
"""

from __future__ import annotations

import time
from typing import Any

__all__ = ["get_time", "Timer", "block_until_ready_time"]


def get_time() -> float:
    """Seconds since an arbitrary epoch, monotonic, high resolution."""
    return time.perf_counter()


class Timer:
    """``with Timer() as t: ...; t.elapsed`` — simple scoped timer."""

    def __init__(self) -> None:
        self.start: float = 0.0
        self.elapsed: float = 0.0

    def __enter__(self) -> "Timer":
        self.start = get_time()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = get_time() - self.start


def _cuda_devices(out: Any, found: set) -> None:
    """Add the CUDA device of every tensor in ``out`` (nested in lists,
    tuples and dict values) to ``found``."""
    import torch

    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (list, tuple)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)


def block_until_ready_time(fn, *args, **kwargs) -> tuple[Any, float]:
    """Run ``fn``, then wait for the CUDA device of every tensor in its
    output before reading the clock; return ``(result, seconds)``.
    Non-tensor results and CPU tensors pass through (nothing to wait
    for)."""
    import torch

    t0 = get_time()
    out = fn(*args, **kwargs)
    devices: set = set()
    _cuda_devices(out, devices)
    for d in devices:
        torch.cuda.synchronize(d)
    return out, get_time() - t0
