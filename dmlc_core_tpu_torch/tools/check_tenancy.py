#!/usr/bin/env python
"""Multi-tenant serving drill: many models, one fleet.

    python -m dmlc_core_tpu_torch.tools.check_tenancy [--device cpu]

The port of ``scripts/check_tenancy.py``.  Stands up ``FleetTracker`` + 3
tenancy-enabled subprocess replicas on the parent's ``--device``
(``FLEET_DEVICE``; ``cuda`` by default) — six tenants, each with its own
v1 ``HistGBT``, residency cap 4 so that paging is certain — + an
in-process tenant-aware router, then drives the incidents the tenancy
tier exists to absorb, with closed-loop bit-verified Zipf tenant load
running THROUGH every incident:

1. **Poisoned publish** — mid-traffic, a tenant-scoped staged rollout
   deploys a model trained on permuted labels for ONE tenant.  The
   per-wave eval gate (holdout MSE against the v1 baseline, scored on the
   replica that serves the new version) must trip, the rollout must roll
   back, and every OTHER tenant's current pointer must be untouched —
   zero dropped, zero wrong across the event.
2. **Hot-tenant surge** — a second router with a tight admission
   envelope (low in-flight cap, bronze sheds at 12.5%) takes a Zipf surge
   whose head is a bronze tenant.  Bronze must shed (429) while gold
   never class-sheds and nobody drops.
3. **Paging churn** — round-robin direct predicts over all six tenants on
   every replica force LRU evictions and restores; every answer must stay
   bit-identical to the expected v1 predictions, and the restores are
   page-ins with zero kernel builds or library loads on any replica (the
   port's counterpart of JAX's compile-cache-backed warm restores).

The JSON report goes to ``TENANCY_OUT``.  The parent runs under
``DMLC_LOCKCHECK=1`` + ``DMLC_RACECHECK=1`` + ``DMLC_LEAKCHECK=1``
(reports at ``TENANCY_RACECHECK_OUT`` / ``TENANCY_LEAKCHECK_OUT``); every
process spools metrics and trace shards (merged at
``TENANCY_METRICS_OUT`` / ``TENANCY_TRACE_OUT``), and GREEN also needs
the per-tenant scorecard ``tools/slo/tenancy.json`` (the JAX package's
``scripts/slo/tenancy.json``; scorecard at ``TENANCY_SLO_OUT``).
Exit 0 = drill green.
"""

import argparse
import json
import os
import tempfile
import threading
import time

from dmlc_core_tpu_torch.tools._drill import (check, gate_checkers,
                                              install_checkers, out, slo_gate)
from dmlc_core_tpu_torch.tools.trace_collect import collect

_HERE = os.path.dirname(os.path.abspath(__file__))

N_REPLICAS = 3
N_ROWS, N_FEAT = 400, 8
TENANTS = ["t0", "t1", "t2", "t3", "t4", "t5"]
CLASSES = "gold:t0;bronze:t4,t5"
POISON = "t2"                      # the tenant whose v2 is poisoned
RESIDENT_CAP = 4                   # < len(TENANTS): paging guaranteed
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
    install_checkers(trace=True)
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_tenancy_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()

    import numpy as np

    from dmlc_core_tpu_torch.base import metrics_agg
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.serve.client import ResilientClient
    from dmlc_core_tpu_torch.serve.fleet import (FleetRouter, FleetTracker,
                                                 HttpFleetAdmin, Rollout,
                                                 run_loadgen, spawn_replica)
    from dmlc_core_tpu_torch.serve.tenancy import (TenantPolicy,
                                                   checkpoint_tenant_model)

    spool_writer = metrics_agg.install_spool("drill", 0)
    out_path = out("TENANCY_OUT", "tenancy_drill.json")
    report = {"device": device, "phases": {}}
    tmp = tempfile.mkdtemp(prefix="dmlc_tenancy")

    # -- six tenants, six different v1 models (all HistGBT: the tree
    # engine is bit-exact across batch shapes, so the loadgen's
    # bit-equality oracle holds through padding AND paging) -------------
    rng = np.random.default_rng(42)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    models, npz = {}, {"X": X}
    for i, t in enumerate(TENANTS):
        y = (X[:, i % N_FEAT] + X[:, (i + 1) % N_FEAT]
             * X[:, (i + 2) % N_FEAT] > 0).astype(np.float32)
        m = HistGBT(device=device, n_trees=3 + i, max_depth=3,
                    n_bins=16).fit(X, y)
        models[t] = (m, y)
        npz[f"{t}__v1"] = m.predict(X)
        checkpoint_tenant_model(f"file://{tmp}/{t}_v1.ckpt", t, m,
                                version=1)
    # the poisoned v2: same family, labels permuted — a model that
    # trains fine and serves fine but predicts garbage
    y_poison = np.random.default_rng(7).permutation(models[POISON][1])
    m_poison = HistGBT(device=device, n_trees=4, max_depth=3,
                       n_bins=16).fit(X, y_poison)
    poison_uri = f"file://{tmp}/{POISON}_v2.ckpt"
    checkpoint_tenant_model(poison_uri, POISON, m_poison, version=2)
    npz[f"{POISON}__v2"] = m_poison.predict(X)   # transient v2 answers
    expected_npz = os.path.join(tmp, "expected.npz")
    np.savez(expected_npz, **npz)

    X_hold, y_hold = X[:64], models[POISON][1][:64]
    base_mse = float(np.mean(
        (models[POISON][0].predict(X_hold) - y_hold) ** 2))

    child_env = {"DMLC_LOCKCHECK": "1", "DMLC_RACECHECK": "1",
                 "DMLC_TRACE": "1", "DMLC_METRICS_SPOOL": spool,
                 "DMLC_TENANT_RESIDENT_CAP": str(RESIDENT_CAP),
                 "FLEET_DEVICE": device}
    tracker = FleetTracker(nworker=8)
    tracker.start()
    procs = [spawn_replica("127.0.0.1", tracker.port, max_batch=32,
                           tenancy=True, extra_env=child_env)
             for _ in range(N_REPLICAS)]
    router = surge_router = None
    try:
        _wait(lambda: len(tracker.serve_endpoints()) == N_REPLICAS,
              180, "replica registration")
        endpoints = dict(tracker.serve_endpoints())
        admin = HttpFleetAdmin(endpoints)
        for rank in endpoints:
            for t in TENANTS:
                v = admin.load(rank, f"file://{tmp}/{t}_v1.ckpt",
                               activate=True, tenant=t)
                assert v == 1
        check(True, f"{len(TENANTS)} tenants loaded at v1 on "
                     f"{N_REPLICAS} replicas (residency cap "
                     f"{RESIDENT_CAP})")
        for rank in endpoints:
            tdoc = admin.health(rank).get("tenants", {})
            check(sorted(tdoc) == TENANTS
                   and all(d["version"] == 1 for d in tdoc.values()),
                   f"replica {rank} heartbeats all tenants at v1")
            check(sum(d["resident"] for d in tdoc.values())
                   <= RESIDENT_CAP,
                   f"replica {rank} resident count within cap")

        # steady-state policy: generous admission, gold hedges almost
        # always (1ms budget) so the hedge path runs under racecheck
        policy = TenantPolicy(classes=CLASSES, default_class="silver",
                              quota=0, max_inflight=256,
                              shed_fraction=0.5, hedge_ms=1)
        router = FleetRouter(tracker, probe_s=0.2,
                             policy=policy).start()
        client = ResilientClient(router.url)
        preds, ver = client.predict(X[:8], tenant="t1")
        check(ver == 1 and np.array_equal(preds,
                                           npz["t1__v1"][:8]),
               "routed tenant predict bit-identical to direct v1 predict")

        # -- phase 1: poisoned publish for ONE tenant under Zipf load ----
        def _loadgen_bg(result, duration, **kw):
            result.update(run_loadgen(
                router.url, expected_npz, duration_s=duration, procs=2,
                threads=3, base_qps=60.0, timeout_ms=20_000,
                workdir=tmp, env=child_env, tenants=TENANTS, **kw))

        def eval_gate(version):
            # honest gate: score the holdout against each replica that
            # actually serves the candidate version for the tenant
            for rank, url in endpoints.items():
                tdoc = admin.health(rank).get("tenants", {}).get(
                    POISON, {})
                if tdoc.get("version") != version:
                    continue
                p, v = ResilientClient(url).predict(X_hold,
                                                    tenant=POISON)
                if v != version:
                    continue
                mse = float(np.mean((p - y_hold) ** 2))
                print(f"   gate: replica {rank} {POISON} v{version} "
                      f"holdout mse {mse:.4f} (v1 baseline "
                      f"{base_mse:.4f})")
                if mse > 2.0 * base_mse + 1e-6:
                    return False
            return True

        load1 = {}
        t1 = threading.Thread(target=_loadgen_bg, args=(load1, LOAD_S))
        t1.start()
        time.sleep(LOAD_S / 3.0)
        rollout = Rollout(admin, wave_size=1, settle_s=0.3,
                          eval_gate=eval_gate,
                          tenant=POISON).run(poison_uri)
        check(rollout["outcome"] == "rolled_back",
               f"poisoned v2 publish for {POISON} rolled back by the "
               f"eval gate (waves: {rollout['waves']})")
        t1.join(timeout=LOAD_S + 300)
        check(not t1.is_alive(), "poison-phase load generator finished")
        check(load1.get("dropped") == 0 and load1.get("wrong") == 0,
               f"poisoned publish under load: zero dropped / zero wrong "
               f"({load1.get('ok')} ok of {load1.get('count')})")
        check(load1.get("shed") == 0,
               "steady-state admission shed nothing")
        for rank in endpoints:
            tdoc = admin.health(rank).get("tenants", {})
            check(all(tdoc[t]["version"] == 1 for t in TENANTS),
                   f"replica {rank}: every tenant back on v1 "
                   f"(rollback isolated to {POISON})")
        per_t = load1.get("by_tenant", {})
        check(sorted(per_t) == TENANTS
               and all(per_t[t]["ok"] > 0 for t in TENANTS),
               f"Zipf mix served every tenant "
               f"({ {t: per_t[t]['ok'] for t in sorted(per_t)} })")
        report["phases"]["poison"] = {"load": load1, "rollout": rollout,
                                      "base_mse": base_mse}

        # -- phase 2: hot-bronze surge against a tight envelope ----------
        # a second router with its own policy (the envelope is
        # constructor state, so no instrumented attrs mutate mid-run):
        # in-flight cap 8, bronze sheds at 12.5% => any concurrency
        tight = TenantPolicy(classes=CLASSES, default_class="silver",
                             quota=0, max_inflight=8,
                             shed_fraction=0.125, hedge_ms=0)
        surge_router = FleetRouter(tracker, probe_s=0.2,
                                   policy=tight).start()
        surge = {}
        surge.update(run_loadgen(
            surge_router.url, expected_npz, duration_s=LOAD_S, procs=2,
            threads=3, base_qps=300.0, timeout_ms=20_000, workdir=tmp,
            # two attempts only: a bronze 429 that persists across one
            # honored Retry-After becomes a terminal shed quickly
            env=dict(child_env, DMLC_RETRY_MAX_ATTEMPTS="2"),
            tenants=["t4"] + [t for t in TENANTS if t != "t4"],
            zipf_a=1.3))
        check(surge.get("dropped") == 0 and surge.get("wrong") == 0,
               f"surge: zero dropped / zero wrong "
               f"({surge.get('ok')} ok, {surge.get('shed')} shed of "
               f"{surge.get('count')})")
        sb = surge.get("by_tenant", {})
        check(sb.get("t4", {}).get("shed", 0) >= 1,
               f"hot bronze tenant shed first "
               f"(t4 shed {sb.get('t4', {}).get('shed')})")
        check(sb.get("t0", {}).get("shed", 0) == 0
               and sb.get("t0", {}).get("ok", 0) > 0,
               f"gold rode through the surge unshed "
               f"(t0 ok {sb.get('t0', {}).get('ok')})")
        report["phases"]["surge"] = {"load": surge}

        # -- phase 3: paging churn with bit-exact restores ---------------
        builds0 = {r: admin.health(r).get("kernel_builds")
                   for r in endpoints}
        restore_clients = {r: ResilientClient(u)
                           for r, u in endpoints.items()}
        for _round in range(2):
            for rank, c in restore_clients.items():
                for t in TENANTS:
                    p, v = c.predict(X[:16], tenant=t)
                    check(v == 1 and np.array_equal(
                        p, npz[f"{t}__v1"][:16]),
                        f"replica {rank} {t} round {_round}: "
                        f"restore bit-identical at v1")
        docs = {r: admin.health(r) for r in endpoints}
        for rank, doc in docs.items():
            tdoc = doc.get("tenants", {})
            check(sum(d["resident"] for d in tdoc.values())
                   <= RESIDENT_CAP,
                   f"replica {rank} stayed within residency cap "
                   f"after churn")
            check(doc.get("kernel_builds") == builds0[rank],
                   f"replica {rank}: the churn's page-ins built and "
                   f"loaded no kernel ({doc.get('kernel_builds')})")
        devices = {r: d.get("device") for r, d in docs.items()}
        check(sorted(set(devices.values())) == [device],
               f"every replica served on {device} ({devices})")
        report["phases"]["paging"] = {
            rank: doc.get("tenants", {}) for rank, doc in docs.items()}
        report["devices"] = devices
        report["kernel_launches"] = {
            r: d.get("kernel_launches") for r, d in docs.items()}
    finally:
        for r in (router, surge_router):
            if r is not None:
                r.close()
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
        spool_writer.close()
    drill_wall_s = time.time() - t_drill0
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("TENANCY_METRICS_OUT", "tenancy_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= N_REPLICAS + 1,
           f"metrics spool merged {nprocs} processes "
           f"(artifact at {metrics_out})")
    ev = merged["metrics"].get("dmlc_tenant_evictions_total", {})
    ev_total = sum(s["value"] for s in ev.get("series", ()))
    check(ev_total >= 1,
           f"replicas paged tenants out under the cap "
           f"(dmlc_tenant_evictions_total = {ev_total:.0f})")
    rs = merged["metrics"].get("dmlc_tenant_restore_seconds", {})
    rs_count = sum(s.get("count", 0) for s in rs.get("series", ()))
    check(rs_count >= 1,
           f"paged-out tenants restored on demand "
           f"(dmlc_tenant_restore_seconds count = {rs_count:.0f})")

    trace_out = out("TENANCY_TRACE_OUT", "tenancy_trace.json")
    _, tsummary = collect(spool, trace_out)
    cross = {tid: t for tid, t in tsummary["traces"].items()
             if len(t["pids"]) >= 3 and "fleet.route" in t["spans"]
             and "tenant.predict" in t["spans"]}
    check(cross,
           f"{len(cross)} tenant trace(s) crossed loadgen -> router -> "
           f"replica tenant.predict over >= 3 processes (merged trace "
           f"at {trace_out})")
    report["observability"] = {
        "spool_processes_merged": nprocs,
        "traces": len(tsummary["traces"]),
        "cross_process_tenant_traces": len(cross),
        "evictions_total": ev_total,
        "restores_total": rs_count,
        "drill_wall_s": round(drill_wall_s, 3),
    }

    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"   report archived to {out_path}")
    rc_report, lk_report = gate_checkers("TENANCY")

    # -- per-tenant SLO scorecard gate ------------------------------------
    evidence = {
        "loadgen": report["phases"]["poison"]["load"],
        "surge": report["phases"]["surge"]["load"],
        "racecheck": {"races": len(rc_report["races"])},
        "leakcheck": {"leaks": len(lk_report["leaks"])},
    }
    slo_gate("tenancy", "TENANCY", merged, evidence, _HERE)
    print("TENANCY DRILL GREEN")


if __name__ == "__main__":
    main()
