#!/usr/bin/env python
"""Production-day simulation drill: whole-stack chaos, one scorecard.

    python -m dmlc_core_tpu_torch.tools.check_prodsim

The port of ``scripts/check_prodsim.py``.  Runs the port bench's
``--prodsim`` in-process — one composed run where a live event feed
streams into an OnlineTrainer (refreshes published through tenant-scoped
staged rollouts), a sparse-CTR ``fit_ps`` lane trains on a real
multi-process PS fleet, and a multi-tenant replica fleet (fake 6-host
cluster under a LauncherScaler JobSet) serves diurnal Zipf loadgen —
while the deterministic chaos schedule (``at=``/``every=`` wall-clock
triggers, ``DMLC_FAULT_SEED``) injects one fault in EVERY tier mid-run:

* replica SIGKILL, * PS server SIGKILL (respawn + snapshot restore),
* spot-preemption wave downing 30% of hosts at once, * corrupt stream
shard bytes (tailer resync), * poisoned tenant publish (eval gate trips,
rollback stays tenant-scoped).

GREEN requires: availability >= 99% with zero dropped / zero wrong, all
five tiers faulted, host-death respawns charged to the host (not the
rank budget), the PS replacement restoring a snapshot, the stream lane
resyncing and its live tenant staying bit-verified, only the poisoned
tenant rolling back, zero lock-order cycles / races / leaks, zero kernel
builds or loads in the stream lane's steady window (the port's
counterpart of JAX's zero steady-state XLA compiles), and the scorecard
``tools/slo/prodsim.json`` — the JAX package's
``scripts/slo/prodsim.json``, every objective and threshold — passing
end to end.

The run's device is the card; ``BENCH_FORCE_CPU=1`` runs it on the CPU
(the caller asking for the CPU, as the tests do).  Artifacts: report at
``PRODSIM_OUT``, merged metrics at ``PRODSIM_METRICS_OUT``, stitched
trace at ``PRODSIM_TRACE_OUT``, race/leak reports at
``PRODSIM_RACECHECK_OUT`` / ``PRODSIM_LEAKCHECK_OUT``, scorecard at
``PRODSIM_SLO_OUT`` (each defaults to a file in the system's temporary
directory).  Exit 0 = drill green.
"""

import glob
import json
import math
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))


def _check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}")
        sys.exit(1)
    print(f"ok: {msg}")


def _out(var: str, name: str) -> str:
    return os.environ.get(var) or os.path.join(tempfile.gettempdir(), name)


# -- the trace collector's summary (``scripts/trace_collect.py``'s) ---------

def _load_shards(spool_dir: str) -> List[Dict[str, Any]]:
    """Every ``trace-*.json`` shard in ``spool_dir`` (unparseable files
    are skipped — a crashed writer must not sink the merge)."""
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


def collect_traces(spool_dir: str, out_path: Optional[str] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Merge the spool's trace shards onto one timeline (each shard's
    events offset by its ``epoch_us`` from the earliest) and summarise
    them by distributed trace id: the pids, roles and span names each
    request crossed.  Returns ``(merged_doc, summary)``; the merged
    Perfetto JSON is written to ``out_path`` when given."""
    shards = _load_shards(spool_dir)
    epochs = [float(s.get("otherData", {}).get("epoch_us", 0.0))
              for s in shards]
    t0 = min(epochs) if epochs else 0.0
    events: List[Dict[str, Any]] = []
    traces: Dict[str, Dict[str, set]] = {}
    for shard, epoch in zip(shards, epochs):
        other = shard.get("otherData", {})
        role = str(other.get("role", ""))
        for ev in shard["traceEvents"]:
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M" or "ts" not in ev:
                events.append(ev)
            else:
                events.append(dict(ev, ts=float(ev["ts"]) + epoch - t0))
            tid = (ev.get("args") or {}).get("trace")
            if not tid:
                continue
            entry = traces.setdefault(
                str(tid), {"pids": set(), "roles": set(), "spans": set()})
            entry["pids"].add(int(ev.get("pid", other.get("pid", 0))))
            entry["roles"].add(role or "process")
            entry["spans"].add(str(ev.get("name", "")))
    merged = {"traceEvents": events, "displayTimeUnit": "ms",
              "otherData": {"shards": [os.path.basename(s["_path"])
                                       for s in shards]}}
    summary = {"traces": {tid: {k: sorted(v) for k, v in e.items()}
                          for tid, e in traces.items()}}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged, summary


def main() -> None:
    for var in ("DMLC_LOCKCHECK", "DMLC_RACECHECK", "DMLC_LEAKCHECK",
                "DMLC_TRACE"):
        os.environ.setdefault(var, "1")
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_prodsim_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()

    from dmlc_core_tpu_torch.base import (leakcheck, lockcheck, metrics_agg,
                                          racecheck, slo)
    from dmlc_core_tpu_torch.utils import profiler

    # the package's import installs the checkers its env names and reads
    # DMLC_TRACE; under ``-m`` it ran before the env above was set, so
    # apply it here, in its order (leakcheck's Thread.start hook chains
    # racecheck's)
    for checker in (lockcheck, racecheck, leakcheck):
        if checker.env_enabled() and not checker.installed():
            checker.install()
    profiler.set_tracing(os.environ["DMLC_TRACE"].lower()
                         in ("1", "true", "on", "yes"))
    from dmlc_core_tpu_torch import bench

    spool_writer = metrics_agg.install_spool("drill", 0)
    record = bench._prodsim_bench()

    # -- the composed run's own evidence ---------------------------------
    chaos = record["chaos"]
    _check(chaos["tiers_faulted"] >= 5,
           f"chaos touched every tier "
           f"({chaos['tiers']} — schedule {chaos['schedule']!r}, "
           f"seed {chaos['seed']})")
    _check(all(r["fires"] >= 1 for r in chaos["rules"]),
           f"every scheduled chaos rule fired "
           f"({[(r['point'], r['kind'], r['fires']) for r in chaos['rules']]})")
    hosts = int(record["hosts"])
    want_wave = max(1, math.ceil(0.3 * hosts))
    _check(len(chaos["wave_hosts"]) >= want_wave,
           f"spot-preemption wave downed {len(chaos['wave_hosts'])}/{hosts} "
           f"hosts at once (>= 30%: {chaos['wave_hosts']})")
    _check(record["availability"] >= 0.99,
           f"availability {record['availability']:.5f} >= 0.99 through "
           f"all faults ({record['loadgen']['ok']} ok of "
           f"{record['loadgen']['count']})")
    _check(record["dropped"] == 0 and record["wrong"] == 0,
           f"zero dropped / zero wrong across the whole day "
           f"(shed {record['loadgen']['shed']})")

    launch = record["launch"]
    _check(launch["respawns_by_cause"].get("host_death", 0) >= 1,
           f"host deaths respawned without burning rank budgets "
           f"(by cause: {launch['respawns_by_cause']}, per host: "
           f"{launch['host_faults']})")
    _check(launch["giveups"] == 0,
           "no rank gave up: cause-fair budgets absorbed the kills")

    ps = record["ps"]
    _check(ps["victim_sigkilled"] == 1,
           f"PS server 1 SIGKILLed mid-stream (rc={ps['victim_rc']})")
    _check((ps["restored_version"] or 0) >= 1,
           f"PS replacement restored snapshot v{ps['restored_version']} "
           "as the same server id")
    _check(ps["rcs"]["workers"] == [0, 0]
           and all(rc == 0 for rc in ps["rcs"]["servers"]),
           f"PS workers + surviving servers exited clean ({ps['rcs']})")

    stream = record["stream"]
    _check(stream["resyncs"] >= 1,
           f"tailer resynced past the corrupt shard bytes "
           f"({stream['resyncs']} resync(s), "
           f"{stream['events_consumed']} events consumed)")
    _check(stream["live_verified"] == 1,
           f"live tenant v{stream['live_version']} bit-verified after "
           f"{stream['activated']} stream-refresh rollouts")

    rb = record["rollback"]
    _check(rb["poisoned"] == 1,
           f"poisoned publish rolled back by the eval gate "
           f"(waves: {rb['poison_waves']})")
    _check(rb["isolated"] == 1 and rb["static_rollbacks"] == 0,
           "rollback stayed tenant-scoped: every other tenant untouched")

    # -- observability plane: merge spools, stitch the trace -------------
    if spool_writer is not None:
        spool_writer.close()
    drill_wall_s = time.time() - t_drill0
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = _out("PRODSIM_METRICS_OUT", "prodsim_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    _check(nprocs >= 8,
           f"metrics spool merged {nprocs} processes across all lanes "
           f"(artifact at {metrics_out})")
    trace_out = _out("PRODSIM_TRACE_OUT", "prodsim_trace.json")
    _, tsummary = collect_traces(spool, trace_out)
    cross = {tid: t for tid, t in tsummary["traces"].items()
             if len(t["pids"]) >= 3 and "fleet.route" in t["spans"]
             and "tenant.predict" in t["spans"]}
    _check(cross,
           f"{len(cross)} trace(s) crossed loadgen -> router -> replica "
           f"tenant.predict over >= 3 processes (merged trace at "
           f"{trace_out})")

    lockcheck.check()
    print("ok: zero lock-order cycles under DMLC_LOCKCHECK=1 (parent)")
    rc_out = _out("PRODSIM_RACECHECK_OUT", "prodsim_racecheck.json")
    rc_report = racecheck.write_report(rc_out)
    racecheck.check()
    print(f"ok: zero happens-before races under DMLC_RACECHECK=1 "
          f"(parent; report at {rc_out})")
    lk_out = _out("PRODSIM_LEAKCHECK_OUT", "prodsim_leakcheck.json")
    lk_report = leakcheck.write_report(lk_out)
    leakcheck.check()
    print(f"ok: zero live resource leaks under DMLC_LEAKCHECK=1 "
          f"(parent; report at {lk_out})")
    builds = record["jitcheck"]
    _check(builds["recompiles_steady"] == 0,
           f"zero kernel builds or loads in the stream lane's steady "
           f"window ({builds['recompiles_steady']}; window opened: "
           f"{builds['steady_window_opened']})")

    # -- the ONE SLO scorecard gate ---------------------------------------
    spec_path = os.environ.get("PRODSIM_SLO_SPEC") or os.path.join(
        _HERE, "slo", "prodsim.json")
    evidence = dict(record)
    evidence["racecheck"] = {"races": len(rc_report["races"])}
    evidence["leakcheck"] = {"leaks": len(lk_report["leaks"])}
    scorecard = slo.evaluate(slo.SLOSpec.load(spec_path), merged, evidence)
    slo_out = _out("PRODSIM_SLO_OUT", "prodsim_slo.json")
    with open(slo_out, "w") as f:
        json.dump(scorecard, f, indent=2)
    for row in scorecard["objectives"]:
        print(f"   slo[{row['name']}]: "
              f"{'pass' if row['pass'] else 'FAIL'} "
              f"(observed {row['observed']} {row['op']} "
              f"{row['threshold']}; {row['evidence']})")
    _check(scorecard["pass"],
           f"SLO scorecard {scorecard['spec']} green "
           f"(spec {spec_path}, scorecard at {slo_out})")

    report_out = _out("PRODSIM_OUT", "prodsim_drill.json")
    with open(report_out, "w") as f:
        json.dump({
            "record": record,
            "observability": {
                "spool_processes_merged": nprocs,
                "traces": len(tsummary["traces"]),
                "cross_process_traces": len(cross),
                "drill_wall_s": round(drill_wall_s, 3),
            },
            "slo": scorecard,
        }, f, indent=2)
    print(f"   report archived to {report_out}")
    print("PRODSIM DRILL GREEN")


if __name__ == "__main__":
    main()
