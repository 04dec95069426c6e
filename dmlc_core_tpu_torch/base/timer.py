"""Wall-clock timing.

Reference parity: ``include/dmlc/timer.h :: dmlc::GetTime()``.  This
package's own copy of ``dmlc_core_tpu.base.timer``'s host clock (the
fit's timings read it); a device time is taken with CUDA events or after
``torch.cuda.synchronize()`` (work is enqueued asynchronously, so a host
clock alone measures the enqueue).
"""

from __future__ import annotations

import time

__all__ = ["get_time"]


def get_time() -> float:
    """Seconds since an arbitrary epoch, monotonic, high resolution."""
    return time.perf_counter()
