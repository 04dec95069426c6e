"""SLO scorecard engine: declarative objectives over merged metrics.

This package's own copy of ``dmlc_core_tpu/base/slo.py`` (the standard
library only): the same spec format, operators and scorecard.

The last piece of the fleet observability plane: given the fleet-wide
snapshot ``base/metrics_agg.merge_spool`` produces (plus optional
side-channel *evidence* like a drill's loadgen report or leak/race
reports), evaluate a committed :class:`SLOSpec` into a pass/fail
scorecard JSON with per-objective evidence pointers.  ``bench.py
--fleet/--stream/--ps --slo spec.json`` embeds the scorecard in its
final record, and ``scripts/check_fleet.py`` / ``check_ps.py`` gate
GREEN on the committed specs under ``scripts/slo/``.

Spec format (JSON)::

    {"name": "fleet",
     "objectives": [
       {"name": "p99_predict_ms", "op": "<=", "threshold": 250.0,
        "source": {"metric": "dmlc_serve_http_request_seconds",
                   "labels": {"path": "/predict"}, "stat": "p99",
                   "scale": 1000.0}},
       {"name": "wrong_predictions", "op": "==", "threshold": 0,
        "source": {"evidence": "loadgen.wrong"}},
       {"name": "availability", "op": ">=", "threshold": 0.99,
        "source": {"ratio": [{"evidence": "loadgen.ok"},
                             {"evidence": "loadgen.requests"}]}}]}

A ``source`` is one of: a **metric selector** (metric name + label
filter + stat: ``sum``/``value``/``count``/``min``/``max`` or any
histogram quantile ``p<nn>`` — ``p50``, ``p90``, ``p95``, ``p99``, … —
with optional ``scale``), an **evidence pointer** (dotted path into the
caller-supplied evidence dict), or a ``ratio`` of two sources.
Counter/sum-like stats treat an absent series as 0 (a never-incremented
error counter IS zero errors); quantiles over no data are ``None`` and
fail the objective.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["SLOSpec", "evaluate"]

_OPS = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
}

#: stats where "no matching series" legitimately means zero
_ZERO_WHEN_MISSING = {"sum", "value", "count"}

#: any histogram quantile selector: p50, p90, p95, p99, ...
_QUANTILE_STAT = re.compile(r"p([0-9]{1,2})$")


class SLOSpec:
    """A named list of objectives loaded from dict/JSON (validated up
    front so a malformed committed spec fails loudly, not at gate
    time)."""

    def __init__(self, name: str,
                 objectives: Sequence[Dict[str, Any]]) -> None:
        self.name = str(name)
        self.objectives: List[Dict[str, Any]] = []
        for i, obj in enumerate(objectives):
            if "name" not in obj or "op" not in obj or "source" not in obj \
                    or "threshold" not in obj:
                raise ValueError(
                    f"slo spec {name!r}: objective #{i} needs "
                    "name/op/threshold/source")
            if obj["op"] not in _OPS:
                raise ValueError(
                    f"slo spec {name!r}: objective {obj['name']!r} has "
                    f"unknown op {obj['op']!r} (want one of "
                    f"{sorted(_OPS)})")
            self._check_source(obj["source"], obj["name"])
            self.objectives.append(dict(obj))

    def _check_source(self, src: Any, oname: str) -> None:
        if not isinstance(src, dict):
            raise ValueError(f"slo spec {self.name!r}: objective "
                             f"{oname!r} source must be a dict")
        kinds = [k for k in ("metric", "evidence", "ratio") if k in src]
        if len(kinds) != 1:
            raise ValueError(
                f"slo spec {self.name!r}: objective {oname!r} source "
                "must have exactly one of metric/evidence/ratio")
        if "ratio" in src:
            parts = src["ratio"]
            if not (isinstance(parts, list) and len(parts) == 2):
                raise ValueError(
                    f"slo spec {self.name!r}: objective {oname!r} ratio "
                    "wants [numerator, denominator]")
            for part in parts:
                self._check_source(part, oname)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SLOSpec":
        """Build + validate a spec from its dict form."""
        return cls(data.get("name", "slo"), data.get("objectives", ()))

    @classmethod
    def load(cls, path: str) -> "SLOSpec":
        """Load + validate a committed spec JSON file."""
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _dig(evidence: Optional[Dict[str, Any]], path: str) -> Optional[Any]:
    cur: Any = evidence
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _series_matches(series: Dict[str, Any],
                    want: Dict[str, Any]) -> bool:
    labels = series.get("labels", {})
    return all(str(labels.get(k)) == str(v) for k, v in want.items())


def _quantile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def _resolve_metric(src: Dict[str, Any],
                    snapshot: Dict[str, Any]) -> Optional[float]:
    name = src["metric"]
    stat = src.get("stat", "sum")
    want = src.get("labels", {})
    scale = float(src.get("scale", 1.0))
    metric = (snapshot.get("metrics") or {}).get(name)
    series = [s for s in (metric.get("series", ()) if metric else ())
              if _series_matches(s, want)]
    if not series:
        return 0.0 * scale if stat in _ZERO_WHEN_MISSING else None
    kind = metric["kind"] if metric else ""
    if kind == "histogram":
        if stat in ("sum", "count"):
            return sum(s.get(stat, 0) for s in series) * scale
        if stat == "min":
            vals = [s["min"] for s in series if s.get("min") is not None]
            return min(vals) * scale if vals else None
        if stat == "max":
            vals = [s["max"] for s in series if s.get("max") is not None]
            return max(vals) * scale if vals else None
        m = _QUANTILE_STAT.match(stat)
        if m:
            pool: List[float] = []
            for s in series:
                pool.extend(s.get("reservoir", ()))
            q = _quantile(pool, int(m.group(1)) / 100.0)
            return q * scale if q is not None else None
        return None
    # counter / gauge
    if stat in ("sum", "value", "count"):
        return sum(float(s.get("value", 0.0)) for s in series) * scale
    if stat == "min":
        return min(float(s.get("value", 0.0)) for s in series) * scale
    if stat == "max":
        return max(float(s.get("value", 0.0)) for s in series) * scale
    return None


def _resolve(src: Dict[str, Any], snapshot: Dict[str, Any],
             evidence: Optional[Dict[str, Any]]) -> Optional[float]:
    if "metric" in src:
        return _resolve_metric(src, snapshot)
    if "evidence" in src:
        v = _dig(evidence, src["evidence"])
        try:
            return (float(v) * float(src.get("scale", 1.0))
                    if v is not None else None)
        except (TypeError, ValueError):
            return None
    num = _resolve(src["ratio"][0], snapshot, evidence)
    den = _resolve(src["ratio"][1], snapshot, evidence)
    if num is None or den is None or den == 0:
        return None
    return num / den


def _describe(src: Dict[str, Any]) -> str:
    if "metric" in src:
        labels = ",".join(f"{k}={v}"
                          for k, v in sorted(src.get("labels", {}).items()))
        return (f"metric:{src['metric']}"
                + (f"{{{labels}}}" if labels else "")
                + f".{src.get('stat', 'sum')}")
    if "evidence" in src:
        return f"evidence:{src['evidence']}"
    return (f"ratio({_describe(src['ratio'][0])} / "
            f"{_describe(src['ratio'][1])})")


def evaluate(spec: SLOSpec, snapshot: Dict[str, Any],
             evidence: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Evaluate a spec against a (merged) snapshot + evidence dict.

    Returns the scorecard::

        {"spec": name, "pass": bool,
         "objectives": [{"name", "pass", "observed", "op", "threshold",
                         "evidence"}, ...]}

    An objective whose source resolves to ``None`` (no data where data
    is required) FAILS — absence of measurement is not compliance."""
    rows: List[Dict[str, Any]] = []
    for obj in spec.objectives:
        observed = _resolve(obj["source"], snapshot, evidence)
        threshold = float(obj["threshold"])
        ok = (observed is not None
              and bool(_OPS[obj["op"]](observed, threshold)))
        rows.append({
            "name": obj["name"],
            "pass": ok,
            "observed": observed,
            "op": obj["op"],
            "threshold": threshold,
            "evidence": _describe(obj["source"]),
        })
    return {"spec": spec.name,
            "pass": all(r["pass"] for r in rows),
            "objectives": rows}
