"""The metrics spool and its merge in the port (``base/metrics_agg.py``)
on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_metrics_agg.py``'s five classes, ``TestCounterMerge``,
``TestGaugeMerge``, ``TestHistogramMerge``, ``TestDisabledNoOp`` and
``TestSpool``, with nothing left out.

The port's own checks: spool snapshots cross-load both ways — a spool
directory holding snapshots written by JAX processes merges in the port's
``merge_spool`` to exactly the merge JAX's gives, and the reverse, also
for a directory holding both packages' snapshots (histogram reservoirs
included: both cap them at 256 and re-sample with the same seed).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.base import metrics as JM  # noqa: E402
from dmlc_core_tpu.base import metrics_agg as JA  # noqa: E402
from dmlc_core_tpu_torch.base import metrics as TM  # noqa: E402
from dmlc_core_tpu_torch.base import metrics_agg as TA  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402

_AGG = load_port("test_metrics_agg.py")
export(globals(), _AGG, ["TestCounterMerge", "TestGaugeMerge",
                         "TestHistogramMerge", "TestDisabledNoOp",
                         "TestSpool"])
# the loaded file's autouse fixture (a clean registry, no ambient spool)
_isolation = _AGG._isolation


def _fill(M, seed):
    """One process's registry of ``M`` (either package's metrics module):
    a labelled counter, a gauge and a histogram past the reservoir cap."""
    r = M.MetricsRegistry(namespace="dmlc")
    r.counter("reqs_total", labels=("path",)).inc(3 + seed, path="/p")
    r.counter("reqs_total", labels=("path",)).inc(1, path=f"/q{seed}")
    r.gauge("workers").set(seed)
    h = r.histogram("wait_seconds", buckets=(0.01, 0.1, 1.0))
    for i in range(300 + 50 * seed):
        h.observe(((i * (seed + 3)) % 101) / 100.0)
    return r.snapshot()


@pytest.mark.parametrize("writers", ["jax", "port", "both"])
def test_spool_merges_alike_in_both_packages(writers, tmp_path):
    mods = {"jax": [(JM, JA)] * 3, "port": [(TM, TA)] * 3,
            "both": [(JM, JA), (TM, TA), (JM, JA)]}[writers]
    for i, (M, A) in enumerate(mods):
        A.write_snapshot(str(tmp_path / f"replica-{i}-{100 + i}.json"),
                         _fill(M, i))
    jax_merged, jn = JA.merge_spool(str(tmp_path))
    port_merged, tn = TA.merge_spool(str(tmp_path))
    assert jn == tn == 3
    assert port_merged == jax_merged
    hist = port_merged["metrics"]["dmlc_wait_seconds"]["series"][0]
    assert hist["count"] == 300 + 350 + 400
    assert len(hist["reservoir"]) == 256
    # a snapshot each package wrote holds its reservoir at the same cap
    assert len(_fill(TM, 0)["metrics"]["dmlc_wait_seconds"]["series"][0]
               ["reservoir"]) == TM._RESERVOIR_SIZE == JM._RESERVOIR_SIZE


def test_port_spool_file_is_a_jax_snapshot(tmp_path, monkeypatch):
    """A port process's spool writer leaves a file JAX merges, with the
    JAX package's file name and the spool's own write counter."""
    monkeypatch.setenv("DMLC_METRICS_SPOOL", str(tmp_path))
    TM.default_registry().counter("reqs_total").inc(5)
    writer = TA.SpoolWriter(str(tmp_path), "replica", 2, period_s=0)
    writer.start()
    writer.close()
    assert os.path.basename(writer.path).startswith("replica-2-")
    merged, n = JA.merge_spool(str(tmp_path))
    assert n == 1
    series = {s["labels"].get("role"): s["value"] for s in
              merged["metrics"]["dmlc_spool_writes_total"]["series"]}
    assert series["replica"] >= 2
    assert merged["metrics"]["dmlc_reqs_total"]["series"][0]["value"] == 5


def test_histogram_sum_and_quantile_as_jax():
    """The port's ``Histogram`` has JAX's ``sum()`` and ``quantile()``
    (a fleet replica's ``/healthz`` reads the queue wait's p99 with it)
    and answers as JAX's over the same observations, below the
    reservoir's cap."""
    values = [((i * 37) % 101) / 50.0 for i in range(200)]
    hists = [M.MetricsRegistry(namespace="dmlc").histogram(
        "wait_seconds", labels=("batcher",)) for M in (JM, TM)]
    for h in hists:
        for v in values:
            h.observe(v, batcher="b")
    jh, th = hists
    assert th.sum(batcher="b") == pytest.approx(jh.sum(batcher="b"))
    assert th.sum(batcher="other") == jh.sum(batcher="other") == 0.0
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q, batcher="b") == jh.quantile(q, batcher="b")
    assert th.quantile(0.5, batcher="other") is None
