"""Process-wide metrics: Counter / Gauge / Histogram + exporters.

This package's own copy of the part of ``dmlc_core_tpu.base.metrics``
the port records (the collectives' call, byte and histogram-sync
counters; the boosting loop's rounds, trees and phase times), with the
same data model and snapshot format, so one scraper reads both packages:

* **Label-aware**: a metric is declared once with its label *names*;
  each distinct label-value combination is an independent series
  (``counter.inc(1, op="allreduce")``), Prometheus's data model.
* **Thread-safe**: every metric guards its series map with its own lock.
* **Near-zero disabled cost**: one module-level bool; every instrument
  method begins ``if not _ENABLED: return``.  Toggle with
  :func:`set_enabled` or the ``DMLC_METRICS=0`` env var.
* **Exporters**: :meth:`MetricsRegistry.to_prometheus` (text exposition
  format) and :meth:`MetricsRegistry.snapshot` (JSON-serializable dict).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "enabled", "set_enabled",
           "DEFAULT_TIME_BUCKETS"]

#: log-spaced seconds buckets covering 10 µs .. 60 s (the JAX package's)
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
#: observations a histogram series keeps for its quantiles (the JAX
#: package's size: a snapshot's reservoir is what the cross-process merge,
#: ``base/metrics_agg.py``, re-samples, so both packages cap it alike)
_RESERVOIR_SIZE = 256

_ENABLED = os.environ.get("DMLC_METRICS", "1").lower() not in (
    "0", "false", "off", "no")


def enabled() -> bool:
    """Fast global collection switch."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Turn collection on/off process-wide (also: ``DMLC_METRICS=0``)."""
    global _ENABLED
    _ENABLED = bool(on)


def _label_key(names: Tuple[str, ...], labels: Dict[str, Any]) -> Tuple[str, ...]:
    """Validate + order label kwargs into the series key.  Strict: a
    typo'd or missing label is a bug at the call site, not a new
    series."""
    if set(labels) != set(names):
        raise ValueError(
            f"metric labels mismatch: declared {sorted(names)}, "
            f"got {sorted(labels)}")
    return tuple(str(labels[n]) for n in names)


def _escape_label(value: str) -> str:
    """Label-value escaping per the text exposition format (backslash
    first so the escapes themselves are not re-escaped)."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers render bare."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _MetricBase:
    """Shared declaration + series bookkeeping."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _series_items(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._series.items())

    def _render_labels(self, key: Tuple[str, ...],
                       extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = list(zip(self.label_names, key)) + list(extra)
        if not pairs:
            return ""
        inner = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
        return "{" + inner + "}"

    def value(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def _export(self) -> Iterator[str]:
        for key, v in sorted(self._series_items()):
            yield f"{self.name}{self._render_labels(key)} {_fmt(v)}"


class Counter(_MetricBase):
    """Monotonically increasing count (events, rows, bytes)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not _ENABLED:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _snap(self) -> List[Dict[str, Any]]:
        return [{"labels": dict(zip(self.label_names, key)), "value": v}
                for key, v in sorted(self._series_items())]


class Gauge(_MetricBase):
    """Point-in-time value that can go up and down."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()) -> None:
        super().__init__(name, help, labels)
        # wall-clock write time per series (the snapshot carries it, as
        # the JAX package's does)
        self._ts: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: Any) -> None:
        if not _ENABLED:
            return
        key = _label_key(self.label_names, labels)
        now = time.time()
        with self._lock:
            self._series[key] = float(value)
            self._ts[key] = now

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not _ENABLED:
            return
        key = _label_key(self.label_names, labels)
        now = time.time()
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount
            self._ts[key] = now

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._ts.clear()

    def _snap(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = sorted(self._series.items())
            ts = dict(self._ts)
        return [{"labels": dict(zip(self.label_names, key)), "value": v,
                 "ts": ts.get(key, 0.0)}
                for key, v in items]


class _HistSeries:
    """One label combination's state: fixed bucket counts, exact
    sum/count/min/max and a bounded reservoir (algorithm R) for the
    quantiles."""

    __slots__ = ("counts", "sum", "count", "min", "max", "reservoir", "_rng")

    def __init__(self, n_buckets: int, seed: int) -> None:
        self.counts = [0] * (n_buckets + 1)          # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")
        self.reservoir: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float, bounds: Tuple[float, ...]) -> None:
        i = 0
        for b in bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.reservoir) < _RESERVOIR_SIZE:
            self.reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < _RESERVOIR_SIZE:
                self.reservoir[j] = v

    def quantile(self, q: float) -> Optional[float]:
        if not self.reservoir:
            return None
        s = sorted(self.reservoir)
        return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


class Histogram(_MetricBase):
    """Distribution of observations: cumulative fixed buckets for
    Prometheus, reservoir quantiles for the JSON snapshot."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None) -> None:
        super().__init__(name, help, labels)
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_TIME_BUCKETS
        if not bs:
            raise ValueError(f"histogram {self.name}: empty buckets")
        self.buckets: Tuple[float, ...] = bs

    def observe(self, value: float, **labels: Any) -> None:
        if not _ENABLED:
            return
        key = _label_key(self.label_names, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = _HistSeries(len(self.buckets),
                                     seed=hash((self.name, key)) & 0xFFFF)
                self._series[key] = series
            series.observe(float(value), self.buckets)

    def count(self, **labels: Any) -> int:
        key = _label_key(self.label_names, labels)
        with self._lock:
            s = self._series.get(key)
            return s.count if s is not None else 0

    def sum(self, **labels: Any) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            s = self._series.get(key)
            return s.sum if s is not None else 0.0

    def quantile(self, q: float, **labels: Any) -> Optional[float]:
        key = _label_key(self.label_names, labels)
        with self._lock:
            s = self._series.get(key)
            return s.quantile(q) if s is not None else None

    def time(self, **labels: Any) -> "_HistTimer":
        """``with hist.time(...):`` — observe the block's wall seconds
        (nothing is read or locked while collection is off)."""
        return _HistTimer(self, labels)

    def _export(self) -> Iterator[str]:
        for key, s in sorted(self._series_items()):
            cum = 0
            for bound, c in zip(self.buckets, s.counts):
                cum += c
                yield (f"{self.name}_bucket"
                       f"{self._render_labels(key, (('le', _fmt(bound)),))}"
                       f" {cum}")
            cum += s.counts[-1]
            yield (f"{self.name}_bucket"
                   f"{self._render_labels(key, (('le', '+Inf'),))} {cum}")
            yield f"{self.name}_sum{self._render_labels(key)} {_fmt(s.sum)}"
            yield f"{self.name}_count{self._render_labels(key)} {s.count}"

    def _snap(self) -> List[Dict[str, Any]]:
        out = []
        for key, s in sorted(self._series_items()):
            cum = 0
            bkt = []
            for bound, c in zip(self.buckets, s.counts):
                cum += c
                bkt.append([bound, cum])
            bkt.append(["+Inf", cum + s.counts[-1]])
            out.append({
                "labels": dict(zip(self.label_names, key)),
                "count": s.count, "sum": s.sum,
                "min": s.min if s.count else None,
                "max": s.max if s.count else None,
                "buckets": bkt,
                "quantiles": {f"p{int(q * 100)}": s.quantile(q)
                              for q in (0.5, 0.9, 0.99)},
                "reservoir": list(s.reservoir),
            })
        return out


class _HistTimer:
    """Context manager behind :meth:`Histogram.time`."""

    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: Histogram, labels: Dict[str, Any]) -> None:
        self._hist = hist
        self._labels = labels
        self._t0 = 0.0

    def __enter__(self) -> "_HistTimer":
        if _ENABLED:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        if _ENABLED and self._t0:
            self._hist.observe(time.perf_counter() - self._t0,
                               **self._labels)


class MetricsRegistry:
    """Named collection of metrics with get-or-create declaration.

    Declaring the same (name, kind) twice returns the existing metric;
    re-declaring a name as a different kind or with different labels
    raises."""

    def __init__(self, namespace: str = "dmlc") -> None:
        self.namespace = namespace
        self._lock = threading.Lock()
        self._metrics: Dict[str, _MetricBase] = {}

    def _declare(self, cls, name: str, help: str,
                 labels: Sequence[str], **kw: Any) -> Any:
        full = f"{self.namespace}_{name}" if self.namespace else name
        with self._lock:
            existing = self._metrics.get(full)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {full!r} already declared as "
                        f"{existing.kind}, not {cls.kind}")
                if existing.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {full!r} label mismatch: "
                        f"{existing.label_names} vs {tuple(labels)}")
                return existing
            m = cls(full, help, labels, **kw)
            self._metrics[full] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def metrics(self) -> List[_MetricBase]:
        with self._lock:
            return list(self._metrics.values())

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._export())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable dump of every series."""
        out: Dict[str, Any] = {"namespace": self.namespace, "metrics": {}}
        for m in sorted(self.metrics(), key=lambda m: m.name):
            out["metrics"][m.name] = {
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.label_names),
                "series": m._snap(),
            }
        return out

    def save_json(self, path: str) -> str:
        """Write :meth:`snapshot` to ``path`` (dirs created)."""
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path

    def reset(self) -> None:
        """Zero every series (metric declarations survive)."""
        for m in self.metrics():
            m.clear()


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """Process-wide registry (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default
