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

import json
import math
import os
import tempfile
import time

from dmlc_core_tpu_torch.tools._drill import (check, gate_checkers,
                                              install_checkers, out, slo_gate)
from dmlc_core_tpu_torch.tools.trace_collect import collect

_HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    install_checkers(trace=True)
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_prodsim_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()

    from dmlc_core_tpu_torch import bench
    from dmlc_core_tpu_torch.base import metrics_agg

    spool_writer = metrics_agg.install_spool("drill", 0)
    record = bench._prodsim_bench()

    # -- the composed run's own evidence ---------------------------------
    chaos = record["chaos"]
    check(chaos["tiers_faulted"] >= 5,
           f"chaos touched every tier "
           f"({chaos['tiers']} — schedule {chaos['schedule']!r}, "
           f"seed {chaos['seed']})")
    check(all(r["fires"] >= 1 for r in chaos["rules"]),
           f"every scheduled chaos rule fired "
           f"({[(r['point'], r['kind'], r['fires']) for r in chaos['rules']]})")
    hosts = int(record["hosts"])
    want_wave = max(1, math.ceil(0.3 * hosts))
    check(len(chaos["wave_hosts"]) >= want_wave,
           f"spot-preemption wave downed {len(chaos['wave_hosts'])}/{hosts} "
           f"hosts at once (>= 30%: {chaos['wave_hosts']})")
    check(record["availability"] >= 0.99,
           f"availability {record['availability']:.5f} >= 0.99 through "
           f"all faults ({record['loadgen']['ok']} ok of "
           f"{record['loadgen']['count']})")
    check(record["dropped"] == 0 and record["wrong"] == 0,
           f"zero dropped / zero wrong across the whole day "
           f"(shed {record['loadgen']['shed']})")

    launch = record["launch"]
    check(launch["respawns_by_cause"].get("host_death", 0) >= 1,
           f"host deaths respawned without burning rank budgets "
           f"(by cause: {launch['respawns_by_cause']}, per host: "
           f"{launch['host_faults']})")
    check(launch["giveups"] == 0,
           "no rank gave up: cause-fair budgets absorbed the kills")

    ps = record["ps"]
    check(ps["victim_sigkilled"] == 1,
           f"PS server 1 SIGKILLed mid-stream (rc={ps['victim_rc']})")
    check((ps["restored_version"] or 0) >= 1,
           f"PS replacement restored snapshot v{ps['restored_version']} "
           "as the same server id")
    check(ps["rcs"]["workers"] == [0, 0]
           and all(rc == 0 for rc in ps["rcs"]["servers"]),
           f"PS workers + surviving servers exited clean ({ps['rcs']})")

    stream = record["stream"]
    check(stream["resyncs"] >= 1,
           f"tailer resynced past the corrupt shard bytes "
           f"({stream['resyncs']} resync(s), "
           f"{stream['events_consumed']} events consumed)")
    check(stream["live_verified"] == 1,
           f"live tenant v{stream['live_version']} bit-verified after "
           f"{stream['activated']} stream-refresh rollouts")

    rb = record["rollback"]
    check(rb["poisoned"] == 1,
           f"poisoned publish rolled back by the eval gate "
           f"(waves: {rb['poison_waves']})")
    check(rb["isolated"] == 1 and rb["static_rollbacks"] == 0,
           "rollback stayed tenant-scoped: every other tenant untouched")

    # -- observability plane: merge spools, stitch the trace -------------
    if spool_writer is not None:
        spool_writer.close()
    drill_wall_s = time.time() - t_drill0
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("PRODSIM_METRICS_OUT", "prodsim_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= 8,
           f"metrics spool merged {nprocs} processes across all lanes "
           f"(artifact at {metrics_out})")
    trace_out = out("PRODSIM_TRACE_OUT", "prodsim_trace.json")
    _, tsummary = collect(spool, trace_out)
    cross = {tid: t for tid, t in tsummary["traces"].items()
             if len(t["pids"]) >= 3 and "fleet.route" in t["spans"]
             and "tenant.predict" in t["spans"]}
    check(cross,
           f"{len(cross)} trace(s) crossed loadgen -> router -> replica "
           f"tenant.predict over >= 3 processes (merged trace at "
           f"{trace_out})")

    rc_report, lk_report = gate_checkers("PRODSIM")
    builds = record["jitcheck"]
    check(builds["recompiles_steady"] == 0,
           f"zero kernel builds or loads in the stream lane's steady "
           f"window ({builds['recompiles_steady']}; window opened: "
           f"{builds['steady_window_opened']})")

    # -- the ONE SLO scorecard gate ---------------------------------------
    evidence = dict(record)
    evidence["racecheck"] = {"races": len(rc_report["races"])}
    evidence["leakcheck"] = {"leaks": len(lk_report["leaks"])}
    scorecard = slo_gate("prodsim", "PRODSIM", merged, evidence, _HERE)

    report_out = out("PRODSIM_OUT", "prodsim_drill.json")
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
