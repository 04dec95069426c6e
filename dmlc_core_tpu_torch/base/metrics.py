"""Process-wide metrics: Counter / Gauge + exporters.

This package's own copy of the part of ``dmlc_core_tpu.base.metrics``
the port records (the collectives' call, byte and histogram-sync
counters), with the same data model and snapshot format, so one scraper
reads both packages:

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
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "MetricsRegistry", "default_registry",
           "enabled", "set_enabled"]

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

    def _render_labels(self, key: Tuple[str, ...]) -> str:
        pairs = list(zip(self.label_names, key))
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
                 labels: Sequence[str]) -> Any:
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
            m = cls(full, help, labels)
            self._metrics[full] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

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
