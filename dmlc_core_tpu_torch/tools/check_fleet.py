#!/usr/bin/env python
"""Fleet-serving chaos drill: kill, reroute, rescale, rollout.

    python -m dmlc_core_tpu_torch.tools.check_fleet [--device cpu]

The port of ``scripts/check_fleet.py``.  Stands up the fleet topology —
``FleetTracker`` + 3 subprocess replicas (v1 checkpoint) on the parent's
``--device`` (``FLEET_DEVICE``; ``cuda`` by default) + an in-process
consistent-hash router — and drives it through the incidents the fleet
tier exists to absorb, with closed-loop verified load running THROUGH
every incident:

1. **Kill** — SIGKILL one replica mid-traffic.  The router must fail
   predicts over to surviving replicas (zero dropped, zero wrong), the
   tracker must record the death, and the victim must leave the
   routable set.
2. **Rescale** — the local autoscale backend spawns a replacement
   replica; it registers and joins the routable set.
3. **Rollout** — staged v1→v2 deploy (wave size 1) under load: every
   response bit-matches the version it claims, no request is dropped,
   each replica's observed version sequence is monotone, and the fleet
   converges on v2.

The JSON report (counts, latencies, per-phase verdicts, each replica's
device) goes to ``FLEET_OUT``.  The parent runs under
``DMLC_LOCKCHECK=1`` + ``DMLC_RACECHECK=1`` + ``DMLC_LEAKCHECK=1`` with
zero findings required (reports at ``FLEET_RACECHECK_OUT`` /
``FLEET_LEAKCHECK_OUT``), and with zero kernel builds or library loads in
the parent after the routed warmup predict (``ops/_build.py``'s
``build_events``: the port's counterpart of JAX's zero steady-state XLA
compiles under ``DMLC_JITCHECK=1``; report at ``FLEET_JITCHECK_OUT``).
Every process spools metrics and trace shards (merged at
``FLEET_METRICS_OUT`` / ``FLEET_TRACE_OUT``), and GREEN also needs the
scorecard ``tools/slo/fleet.json`` (the JAX package's
``scripts/slo/fleet.json``; scorecard at ``FLEET_SLO_OUT``).
Exit 0 = drill green.
"""

import argparse
import json
import os
import signal
import tempfile
import threading
import time

from dmlc_core_tpu_torch.tools._drill import (check, gate_checkers,
                                              install_checkers, out, slo_gate)
from dmlc_core_tpu_torch.tools.trace_collect import collect

_HERE = os.path.dirname(os.path.abspath(__file__))

N_REPLICAS = 3
N_ROWS, N_FEAT = 400, 8
LOAD_S = 6.0


def _wait(pred, timeout_s, label):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    check(False, f"timed out waiting for {label}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    from dmlc_core_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(ap.parse_args().device))
    # observability plane: every process (parent router, replicas,
    # loadgen workers) spools metrics + trace shards into one directory
    install_checkers(trace=True)
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_fleet_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()

    import numpy as np

    from dmlc_core_tpu_torch.base import metrics_agg
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.serve import checkpoint_model
    from dmlc_core_tpu_torch.serve.client import ResilientClient
    from dmlc_core_tpu_torch.serve.fleet import (FleetRouter, FleetTracker,
                                                 HttpFleetAdmin,
                                                 LocalProcessScaler, Rollout,
                                                 run_loadgen, spawn_replica)

    spool_writer = metrics_agg.install_spool("drill", 0)
    out_path = out("FLEET_OUT", "fleet_drill.json")
    report = {"device": device, "phases": {}}
    tmp = tempfile.mkdtemp(prefix="dmlc_fleet")

    rng = np.random.default_rng(42)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    m1 = HistGBT(device=device, n_trees=4, max_depth=3, n_bins=16).fit(X, y)
    m2 = HistGBT(device=device, n_trees=8, max_depth=3, n_bins=16).fit(X, y)
    v1_uri = f"file://{tmp}/v1.ckpt"
    v2_uri = f"file://{tmp}/v2.ckpt"
    checkpoint_model(v1_uri, m1, version=1)
    checkpoint_model(v2_uri, m2, version=2)
    expected_npz = os.path.join(tmp, "expected.npz")
    np.savez(expected_npz, X=X, v1=m1.predict(X), v2=m2.predict(X))

    child_env = {"DMLC_LOCKCHECK": "1", "DMLC_RACECHECK": "1",
                 "DMLC_TRACE": "1", "DMLC_METRICS_SPOOL": spool,
                 "FLEET_DEVICE": device}
    tracker = FleetTracker(nworker=8)
    tracker.start()
    procs = [spawn_replica("127.0.0.1", tracker.port, model_uri=v1_uri,
                           max_batch=32, extra_env=child_env)
             for _ in range(N_REPLICAS)]
    scaler = LocalProcessScaler(tracker, v1_uri, spawn_env=child_env)
    router = None
    steady = None
    try:
        _wait(lambda: len(tracker.serve_endpoints()) == N_REPLICAS,
              180, "replica registration")
        check(True, f"{N_REPLICAS} replicas registered with the tracker")
        router = FleetRouter(tracker, probe_s=0.2).start()

        client = ResilientClient(router.url)
        preds, ver = client.predict(X[:8])
        check(ver == 1 and np.array_equal(preds, m1.predict(X)[:8]),
               "routed predict bit-identical to direct v1 predict")
        # the parent's device work (oracle fits and predicts) ends here;
        # everything that follows is HTTP, subprocesses and loadgen: a
        # further kernel build or library load in this process is a
        # steady-state stall
        steady = _build.build_events()

        def _loadgen_bg(result, duration):
            result.update(run_loadgen(
                router.url, expected_npz, duration_s=duration, procs=2,
                threads=3, base_qps=60.0, timeout_ms=10_000,
                workdir=tmp, env=child_env))

        # -- phase 1: SIGKILL one replica mid-traffic --------------------
        load1 = {}
        t1 = threading.Thread(target=_loadgen_bg, args=(load1, LOAD_S))
        t1.start()
        time.sleep(LOAD_S / 3.0)
        victim = procs[1]
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=30)
        check(victim.returncode == -signal.SIGKILL,
               f"victim replica SIGKILLed (rc={victim.returncode})")
        _wait(lambda: len(tracker.serve_endpoints()) == N_REPLICAS - 1,
              60, "tracker dropping the dead endpoint")
        check(tracker.dead_workers,
               f"tracker recorded the death (ranks {tracker.dead_workers})")
        t1.join(timeout=LOAD_S + 180)
        check(not t1.is_alive(), "kill-phase load generator finished")
        check(load1.get("dropped") == 0 and load1.get("wrong") == 0,
               f"kill under load: zero dropped / zero wrong "
               f"({load1.get('ok')} ok of {load1.get('count')})")
        router.probe_now()
        docs = router.replica_docs()
        healthy = sorted(r for r, d in docs.items() if d["healthy"])
        check(len(healthy) == N_REPLICAS - 1,
               f"router routable set shrank to survivors {healthy}")
        report["phases"]["kill"] = {"load": load1,
                                    "dead": list(tracker.dead_workers)}

        # -- phase 2: autoscale backend spawns a replacement -------------
        scaler.scale(1)
        _wait(lambda: len(tracker.serve_endpoints()) == N_REPLICAS,
              180, "scaled-out replica registration")
        router.probe_now()
        healthy = sorted(r for r, d in router.replica_docs().items()
                         if d["healthy"])
        check(len(healthy) == N_REPLICAS,
               f"autoscale spawn path restored the fleet {healthy}")
        report["phases"]["rescale"] = {"healthy": healthy}

        # -- phase 3: staged rollout v1 -> v2 under load ------------------
        endpoints = dict(tracker.serve_endpoints())
        versions_seen = {r: [] for r in endpoints}
        stop_watch = threading.Event()

        def _watch():
            cs = {r: ResilientClient(u) for r, u in endpoints.items()}
            while not stop_watch.is_set():
                for r, c in cs.items():
                    try:
                        v = c.healthz().get("version")
                        if v is not None:
                            versions_seen[r].append(int(v))
                    except Exception:  # noqa: BLE001 — probe best-effort
                        pass
                time.sleep(0.05)

        watcher = threading.Thread(target=_watch, daemon=True)
        watcher.start()
        load2 = {}
        t2 = threading.Thread(target=_loadgen_bg, args=(load2, LOAD_S))
        t2.start()
        time.sleep(LOAD_S / 4.0)
        rollout = Rollout(HttpFleetAdmin(endpoints), wave_size=1,
                          settle_s=0.3).run(v2_uri)
        check(rollout["outcome"] == "activated",
               f"staged rollout activated v{rollout['version']} in "
               f"{len(rollout['waves'])} waves of 1")
        t2.join(timeout=LOAD_S + 180)
        check(not t2.is_alive(), "rollout-phase load generator finished")
        stop_watch.set()
        watcher.join(timeout=30)
        check(load2.get("dropped") == 0 and load2.get("wrong") == 0,
               f"rollout under load: zero dropped / zero wrong "
               f"({load2.get('ok')} ok of {load2.get('count')})")
        check("2" in load2.get("by_version", {}),
               f"v2 served live traffic ({load2.get('by_version')})")
        for r, seq in versions_seen.items():
            check(seq == sorted(seq),
                   f"replica {r} version sequence monotone "
                   f"({seq[0] if seq else '?'}→{seq[-1] if seq else '?'})")
        docs = {r: ResilientClient(u).healthz() for r, u in endpoints.items()}
        final = {r: d.get("version") for r, d in docs.items()}
        check(all(v == rollout["version"] for v in final.values()),
               f"fleet converged on v{rollout['version']} ({final})")
        devices = {r: d.get("device") for r, d in docs.items()}
        check(sorted(set(devices.values())) == [device],
               f"every replica served on {device} ({devices})")
        report["phases"]["rollout"] = {"load": load2, "rollout": rollout,
                                       "final_versions": final}
        report["devices"] = devices
        report["kernel_launches"] = {
            r: d.get("kernel_launches") for r, d in docs.items()}
    finally:
        if router is not None:
            router.close()
        scaler.reap(timeout=15)
        for p in procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=15)
                except Exception:  # noqa: BLE001
                    p.kill()
                    p.wait()
        tracker.stop()

    # -- observability plane: merge spools, stitch the trace -------------
    if spool_writer is not None:
        spool_writer.close()    # final parent snapshot + trace shard
    drill_wall_s = time.time() - t_drill0
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("FLEET_METRICS_OUT", "fleet_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= 3,
           f"metrics spool merged {nprocs} processes "
           f"(artifact at {metrics_out})")
    # merged request counters must equal the per-process sum EXACTLY
    shard_sum = 0.0
    for fname in merged["spool_files"]:
        with open(os.path.join(spool, fname)) as f:
            snap = json.load(f)
        m = (snap.get("metrics") or {}).get("dmlc_serve_requests_total")
        shard_sum += sum(s["value"] for s in (m or {}).get("series", ()))
    merged_m = merged["metrics"].get("dmlc_serve_requests_total", {})
    merged_sum = sum(s["value"] for s in merged_m.get("series", ()))
    check(merged_sum == shard_sum and merged_sum > 0,
           f"merged dmlc_serve_requests_total == per-process sum "
           f"({merged_sum:.0f})")

    t_tc0 = time.time()
    trace_out = out("FLEET_TRACE_OUT", "fleet_trace.json")
    _, tsummary = collect(spool, trace_out)
    trace_collect_s = time.time() - t_tc0
    cross = {tid: t for tid, t in tsummary["traces"].items()
             if len(t["pids"]) >= 3 and "fleet.route" in t["spans"]
             and "batcher.submit" in t["spans"]
             and any(s.startswith("http./predict") for s in t["spans"])}
    check(cross,
           f"{len(cross)} request trace(s) crossed router -> replica -> "
           f"batcher spans over >= 3 processes (merged Perfetto trace "
           f"at {trace_out})")
    report["observability"] = {
        "spool_processes_merged": nprocs,
        "traces": len(tsummary["traces"]),
        "cross_process_traces": len(cross),
        "trace_collect_s": round(trace_collect_s, 3),
        "drill_wall_s": round(drill_wall_s, 3),
    }

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"   report archived to {out_path}")
    rc_report, lk_report = gate_checkers("FLEET")
    after = _build.build_events()
    builds_steady = sum(after.values()) - sum(steady.values())
    jc_out = out("FLEET_JITCHECK_OUT", "fleet_jitcheck.json")
    with open(jc_out, "w") as f:
        json.dump({"compiles_steady": builds_steady, "steady": steady,
                   "after": after}, f, indent=2)
    check(builds_steady == 0,
           f"zero kernel builds or library loads in the parent's steady "
           f"window ({after}; report at {jc_out})")

    # -- SLO scorecard gate ----------------------------------------------
    evidence = {
        "loadgen": report["phases"]["rollout"]["load"],
        "racecheck": {"races": len(rc_report["races"])},
        "leakcheck": {"leaks": len(lk_report["leaks"])},
        "jitcheck": {"recompiles_steady": builds_steady},
    }
    slo_gate("fleet", "FLEET", merged, evidence, _HERE)
    print("FLEET CHAOS DRILL GREEN")


if __name__ == "__main__":
    main()
