"""Merge per-process trace shards into one Perfetto timeline.

    python -m dmlc_core_tpu_torch.tools.trace_collect <spool_dir> [-o merged.json]

The port's counterpart of the repository's ``scripts/trace_collect.py``:
every process that ran with ``DMLC_TRACE=1`` and a metrics spool
(``DMLC_METRICS_SPOOL``) saved its Chrome-trace shard to
``<spool>/trace-<role>-<rank>-<pid>.json`` at exit
(``base.metrics_agg.SpoolWriter``), its timestamps relative to its own
monotonic zero and ``otherData.epoch_us`` the same instant on the wall
clock.  :func:`collect` puts every event on one timeline (offset by its
shard's epoch from the earliest shard's), keeps each shard's
``process_name`` / ``thread_name`` rows, writes one ``chrome://tracing``
/ Perfetto file and returns a summary by distributed trace id
(``base.tracectx`` stamps ``trace`` / ``span`` / ``parent`` into span
args): the pids, roles and span names each request crossed, with the
shards' process, event and dropped-event totals; the drills merge their
traces with it.  Host code: it needs no device.  The CLI prints the
summary and exits 1 when the spool holds no shard.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["collect", "load_shards", "main"]


def load_shards(spool_dir: str) -> List[Dict[str, Any]]:
    """Every ``trace-*.json`` shard in ``spool_dir`` (unparseable files
    are skipped: a crashed writer must not sink the merge)."""
    shards = []
    for path in sorted(glob.glob(os.path.join(spool_dir, "trace-*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("traceEvents"), list):
            doc["_path"] = path
            shards.append(doc)
    return shards


def _merge_events(shards: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    epochs = [float(s.get("otherData", {}).get("epoch_us", 0.0))
              for s in shards]
    t0 = min(epochs) if epochs else 0.0
    merged: List[Dict[str, Any]] = []
    for shard, epoch in zip(shards, epochs):
        for ev in shard["traceEvents"]:
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M" or "ts" not in ev:
                merged.append(ev)     # metadata rows carry no timestamp
            else:
                merged.append(dict(ev, ts=float(ev["ts"]) + epoch - t0))
    return merged


def _trace_summary(shards: List[Dict[str, Any]]) -> Dict[str, Any]:
    traces: Dict[str, Dict[str, set]] = {}
    for shard in shards:
        other = shard.get("otherData", {})
        role = str(other.get("role", ""))
        for ev in shard["traceEvents"]:
            if not isinstance(ev, dict):
                continue
            tid = (ev.get("args") or {}).get("trace")
            if not tid:
                continue
            entry = traces.setdefault(
                str(tid), {"pids": set(), "roles": set(), "spans": set()})
            entry["pids"].add(int(ev.get("pid", other.get("pid", 0))))
            entry["roles"].add(role or "process")
            entry["spans"].add(str(ev.get("name", "")))
    return {tid: {k: sorted(v) for k, v in e.items()}
            for tid, e in traces.items()}


def collect(spool_dir: str, out_path: Optional[str] = None
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Merge every trace shard under ``spool_dir``.

    Returns ``(merged_doc, summary)``: the Perfetto JSON (written to
    ``out_path`` when given) and, by distributed trace id, the pids,
    roles and span names it crossed, with ``processes`` / ``events`` /
    ``dropped_events`` totals."""
    shards = load_shards(spool_dir)
    events = _merge_events(shards)
    dropped = sum(int(s.get("otherData", {}).get("dropped_events", 0))
                  for s in shards)
    merged = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"shards": [os.path.basename(s["_path"])
                                 for s in shards],
                      "dropped_events": dropped},
    }
    summary = {
        "processes": len({int(s.get("otherData", {}).get("pid", i))
                          for i, s in enumerate(shards)}),
        "events": sum(1 for ev in events if ev.get("ph") != "M"),
        "dropped_events": dropped,
        "traces": _trace_summary(shards),
    }
    if out_path:
        d = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(d, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged, summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spool_dir", help="DMLC_METRICS_SPOOL directory "
                                      "holding trace-*.json shards")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged Perfetto JSON here")
    args = ap.parse_args(argv)
    _, summary = collect(args.spool_dir, args.out)
    json.dump(summary, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0 if summary["processes"] else 1


if __name__ == "__main__":
    sys.exit(main())
