"""The port's metrics, threaded-iterator instrumentation and profiler
(``base/metrics.py``, ``io/threaded_iter.py``, ``utils/profiler.py``)
on the CPU.

``tests/test_metrics.py`` is loaded against the port whole (``*_port``).
The port's own checks: ``device_trace`` writes a Chrome trace of the
block and yields the ``torch.profiler`` profile, whose operators carry
the ``annotate`` / ``step_annotation`` names; a profiler that cannot
start (its logdir cannot be made) leaves the block running, untraced.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu_torch.utils import profiler  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402

torch.set_num_threads(2)

_METRICS = load_port("test_metrics.py")
export(globals(), _METRICS, [n for n in dir(_METRICS)
                             if n.startswith("Test")])


def _work():
    return torch.ones(32, 32) @ torch.ones(32, 32)


def test_device_trace_writes_the_annotated_regions(tmp_path):
    with profiler.device_trace(str(tmp_path / "prof")) as prof:
        for step in range(2):
            with profiler.step_annotation(step, name="fit"):
                with profiler.annotate("matmul_region"):
                    _work()
    assert prof is not None
    names = {e.key for e in prof.key_averages()}
    assert {"fit#0", "fit#1", "matmul_region"} <= names
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    got = {ev.get("name") for ev in doc["traceEvents"]}
    assert {"fit#0", "fit#1", "matmul_region"} <= got


def test_device_trace_degrades_when_it_cannot_start(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    with profiler.device_trace(str(blocker)) as prof:
        out = _work()
    assert prof is None and float(out[0, 0]) == 32.0
    assert blocker.read_text() == ""
