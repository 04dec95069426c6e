"""Cross-process metrics aggregation: the spool-dir protocol + merge.

``base/metrics.py`` is deliberately process-local; since the fleet PRs,
every interesting run is N processes (PS scheduler/servers/workers,
routers/replicas/loadgen, JobSet ranks) and "what is the fleet-wide
p99" has no answer.  This module adds one without any new network
surface:

* **spool protocol** — every participating process periodically (and at
  exit, via ``atexit``) writes its registry
  :meth:`~dmlc_core_tpu_torch.base.metrics.MetricsRegistry.snapshot` to
  ``$DMLC_METRICS_SPOOL/<role>-<rank>-<pid>.json`` through the atomic
  checkpoint writer (tmp + ``os.replace``), so a reader never sees a
  torn file.  When host tracing is on, the process's Tracer shard lands
  next to it as ``trace-<role>-<rank>-<pid>.json`` for
  ``scripts/trace_collect.py``.  :func:`install_spool` is the one-call
  wiring for role entrypoints: a no-op unless ``DMLC_METRICS_SPOOL`` is
  set, idempotent per process.
* **pure merge** — :func:`merge_snapshots` folds any number of
  snapshots into one fleet-wide view: counters sum, gauges resolve
  last-write-wins by their wall-clock ``ts``, histograms merge
  bucket-by-bucket (cumulative counts add exactly) with reservoir
  quantiles re-sampled weighted by each side's observation count.
  Merging a snapshot from a ``DMLC_METRICS=0`` process (no series) is
  a no-op by construction.

A run's launcher calls :func:`merge_spool` at its end to archive ONE
fleet metrics artifact instead of N invisible per-process registries
(the fleet's replicas and load generators install the spool).

The PyTorch port's counterpart of ``dmlc_core_tpu/base/metrics_agg.py``:
the same file names, snapshot format and merge, so a spool written by
processes of either package merges in either.  ``DMLC_METRICS_SPOOL`` and
``DMLC_METRICS_SPOOL_S`` (default 2.0 s) are read from the environment
directly (the port has no knob registry), and the blob write goes
through the port's ``parallel/checkpoint.py``.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.utils import profiler as _profiler

__all__ = ["SpoolWriter", "install_spool", "installed_spool",
           "merge_snapshots", "merge_spool", "write_snapshot"]

#: deterministic seed for reservoir re-sampling during merges — merging
#: the same shards twice must produce the same artifact
_MERGE_SEED = 0x51007


def _sanitize(token: str) -> str:
    return "".join(c if (c.isalnum() or c in "._") else "_"
                   for c in str(token)) or "proc"


def write_snapshot(path: str, snapshot: Dict[str, Any]) -> str:
    """Write one snapshot (or merged view) as JSON, atomically — readers
    racing the writer see the previous complete file, never a torn one."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    data = json.dumps(snapshot, indent=1).encode()
    # lazy import: base -> parallel only inside the call, so module
    # import order stays acyclic
    from dmlc_core_tpu_torch.parallel.checkpoint import _write_blob

    _write_blob(path, lambda stream: stream.write(data))
    return path


class SpoolWriter:
    """Periodic + at-exit snapshot spooler for one process.

    Writes ``<dir>/<role>-<rank>-<pid>.json`` every
    ``DMLC_METRICS_SPOOL_S`` seconds from a daemon flusher thread, and a
    ``trace-<role>-<rank>-<pid>.json`` Tracer shard at :meth:`close`
    when host tracing is enabled.  Respects ``DMLC_METRICS=0``: the
    metrics file is skipped entirely when collection is off.
    """

    def __init__(self, directory: str, role: str, rank: int = 0,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 period_s: Optional[float] = None) -> None:
        self.role = str(role)
        self.rank = int(rank)
        self._registry = (registry if registry is not None
                          else _metrics.default_registry())
        self._period = (float(period_s) if period_s is not None
                        else float(os.environ.get("DMLC_METRICS_SPOOL_S")
                                   or 2.0))
        stem = f"{_sanitize(role)}-{self.rank}-{os.getpid()}"
        self.path = os.path.join(directory, stem + ".json")
        self.trace_path = os.path.join(directory, "trace-" + stem + ".json")
        self._writes = self._registry.counter(
            "spool_writes_total",
            "Metrics-spool snapshot files written by this process "
            "(base/metrics_agg).", labels=("role",))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SpoolWriter":
        """First flush + start the periodic flusher (skipped when the
        period is <= 0; the at-exit flush still runs)."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.flush()
        if self._period > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"metrics-spool-{self.role}-{self.rank}")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                self.flush(save_trace=False)
            except Exception:  # noqa: BLE001 — spooling must never kill work
                pass

    def flush(self, save_trace: bool = False) -> None:
        """Write the current snapshot (and, optionally, the trace
        shard) now."""
        if _metrics.enabled():
            self._writes.inc(1, role=self.role)
            write_snapshot(self.path, self._registry.snapshot())
        if save_trace and _profiler.tracing_enabled():
            tracer = _profiler.global_tracer()
            if tracer.events():
                tracer.save(self.trace_path)

    def close(self) -> None:
        """Stop the flusher thread and write the final snapshot + trace
        shard (also registered with ``atexit`` by
        :func:`install_spool`).  Idempotent."""
        self._stop.set()
        thread = self._thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=max(1.0, 2 * self._period))
        try:
            self.flush(save_trace=True)
        except Exception:  # noqa: BLE001 — exit path must not raise
            pass


_installed: Optional[SpoolWriter] = None
_install_lock = threading.Lock()


def install_spool(role: str, rank: int = 0,
                  registry: Optional[_metrics.MetricsRegistry] = None
                  ) -> Optional[SpoolWriter]:
    """Wire this process into the metrics spool: no-op (returns None)
    unless ``DMLC_METRICS_SPOOL`` names a directory; otherwise starts
    the periodic :class:`SpoolWriter`, stamps the process role/rank
    into the global Tracer's metadata, and registers the final flush
    with ``atexit``.  Idempotent — the first call wins."""
    global _installed
    directory = os.environ.get("DMLC_METRICS_SPOOL", "")
    if not directory:
        return None
    with _install_lock:
        if _installed is not None:
            return _installed
        _installed = writer = SpoolWriter(directory, role, rank,
                                          registry=registry)
    _profiler.global_tracer().set_meta(role=role, rank=int(rank))
    atexit.register(writer.close)
    writer.start()
    return writer


def installed_spool() -> Optional[SpoolWriter]:
    """The process's active :class:`SpoolWriter`, if any."""
    return _installed


# ---------------------------------------------------------------------------
# pure merge
# ---------------------------------------------------------------------------

def _series_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _merge_counter(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    return {"labels": a["labels"], "value": a["value"] + b["value"]}


def _merge_gauge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    # last write wins by wall timestamp; ties keep the later snapshot
    # (b), matching "the most recently read file is freshest"
    return a if a.get("ts", 0.0) > b.get("ts", 0.0) else b


def _quantiles(reservoir: List[float]) -> Dict[str, Optional[float]]:
    out: Dict[str, Optional[float]] = {}
    s = sorted(reservoir)
    for q in (0.5, 0.9, 0.99):
        if not s:
            out[f"p{int(q * 100)}"] = None
        else:
            idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
            out[f"p{int(q * 100)}"] = s[idx]
    return out


def _merge_reservoirs(ra: List[float], ca: int, rb: List[float], cb: int,
                      rng: random.Random) -> List[float]:
    if not ra:
        return list(rb)[:_metrics._RESERVOIR_SIZE]
    if not rb:
        return list(ra)[:_metrics._RESERVOIR_SIZE]
    size = min(_metrics._RESERVOIR_SIZE, len(ra) + len(rb))
    total = max(1, ca + cb)
    out = []
    for _ in range(size):
        pool = ra if rng.random() < ca / total else rb
        out.append(pool[rng.randrange(len(pool))])
    return out


def _merge_hist(name: str, a: Dict[str, Any], b: Dict[str, Any],
                rng: random.Random) -> Dict[str, Any]:
    bounds_a = [bk[0] for bk in a["buckets"]]
    bounds_b = [bk[0] for bk in b["buckets"]]
    if bounds_a != bounds_b:
        raise ValueError(
            f"merge_snapshots: histogram {name!r} bucket bounds differ "
            f"across processes ({bounds_a} vs {bounds_b})")
    # cumulative counts are additive: cum_union(b) = cum_a(b) + cum_b(b)
    buckets = [[bound, ca + cb] for (bound, ca), (_, cb)
               in zip(a["buckets"], b["buckets"])]
    count = a["count"] + b["count"]
    mins = [m for m in (a.get("min"), b.get("min")) if m is not None]
    maxs = [m for m in (a.get("max"), b.get("max")) if m is not None]
    reservoir = _merge_reservoirs(list(a.get("reservoir", ())), a["count"],
                                  list(b.get("reservoir", ())), b["count"],
                                  rng)
    return {
        "labels": a["labels"],
        "count": count,
        "sum": a["sum"] + b["sum"],
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "buckets": buckets,
        "quantiles": _quantiles(reservoir),
        "reservoir": reservoir,
    }


def merge_snapshots(snaps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold registry snapshots into one fleet-wide view (pure, and
    deterministic for a given input order).

    Per series (metric name x label values): counters **sum**, gauges
    resolve **last-write-wins** by their ``ts``, histograms merge
    cumulative buckets exactly and re-sample reservoir quantiles
    weighted by count.  A metric declared with conflicting kinds across
    processes raises ``ValueError``; an empty snapshot (``DMLC_METRICS=0``
    process) contributes nothing."""
    rng = random.Random(_MERGE_SEED)
    merged: Dict[str, Any] = {"namespace": "dmlc", "metrics": {}}
    for snap in snaps:
        if not snap:
            continue
        if snap.get("namespace"):
            merged["namespace"] = snap["namespace"]
        for name, metric in (snap.get("metrics") or {}).items():
            have = merged["metrics"].get(name)
            if have is None:
                merged["metrics"][name] = {
                    "kind": metric["kind"],
                    "help": metric.get("help", ""),
                    "labels": list(metric.get("labels", ())),
                    "series": [dict(s) for s in metric.get("series", ())],
                }
                continue
            if have["kind"] != metric["kind"]:
                raise ValueError(
                    f"merge_snapshots: metric {name!r} declared as "
                    f"{have['kind']} and {metric['kind']} across "
                    "processes")
            by_key = {_series_key(s["labels"]): s for s in have["series"]}
            for s in metric.get("series", ()):
                key = _series_key(s["labels"])
                prev = by_key.get(key)
                if prev is None:
                    by_key[key] = dict(s)
                elif have["kind"] == "counter":
                    by_key[key] = _merge_counter(prev, s)
                elif have["kind"] == "gauge":
                    by_key[key] = dict(_merge_gauge(prev, s))
                else:
                    by_key[key] = _merge_hist(name, prev, s, rng)
            have["series"] = [by_key[k] for k in sorted(by_key)]
    merged["metrics"] = dict(sorted(merged["metrics"].items()))
    return merged


def merge_spool(directory: str) -> Tuple[Dict[str, Any], int]:
    """Read every snapshot file in a spool directory (trace shards are
    skipped) and return ``(merged_snapshot, processes_merged)``.  The
    merged snapshot carries ``processes_merged`` and the contributing
    ``spool_files`` so archived artifacts are self-describing."""
    snaps: List[Dict[str, Any]] = []
    files: List[str] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".json") or name.startswith("trace-"):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue   # racing writer / foreign file: skip, don't fail
        if not isinstance(snap, dict) or "metrics" not in snap:
            continue   # not a registry snapshot (e.g. archived artifact)
        snaps.append(snap)
        files.append(name)
    merged = merge_snapshots(snaps)
    merged["processes_merged"] = len(files)
    merged["spool_files"] = files
    return merged, len(files)
