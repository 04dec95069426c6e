#!/usr/bin/env python
"""Multi-host launch drill: supervised respawn on a fake cluster.

    python -m dmlc_core_tpu_torch.tools.check_launch [--device cpu]

The port of ``scripts/check_launch.py``.  The launch subsystem end to end
without SSH or k8s: the "cluster" is a ``FakeTransport`` of 3 virtual
hosts whose failures are scripted through the ``base/faultinject``
grammar; every worker and replica runs on the parent's ``--device``
(``cuda`` by default; ``DRILL_DEVICE`` / ``FLEET_DEVICE``):

1. **Elastic fit under host death** — an ``ElasticLauncher`` (tracker +
   supervised JobSet) runs a 4-rank data-parallel fit over the 3 fake
   hosts.  Mid-fit — armed once the first stride has committed, where
   the JAX drill counts 60 supervisor ticks from the launch —
   ``launch_host:kill=h1`` downs host ``h1``: it SIGKILLs its worker and
   refuses further spawns there.  The JobSet
   must respawn the lost rank on a SURVIVING host; the replacement
   reclaims its tracker rank inside the grace window, rolls back to the
   recovery floor and replays — and every finished ensemble must be
   byte-identical to an uninterrupted baseline run.
2. **Fleet scale-out over fake hosts** — a ``LauncherScaler`` (the
   JobSet-backed autoscale backend) grows a serving fleet from 2 to 4
   replicas across the fake hosts while a closed-loop verified load
   generator runs through the transition: zero dropped, zero wrong.

The drill runs under ``DMLC_LOCKCHECK=1`` + ``DMLC_RACECHECK=1`` +
``DMLC_LEAKCHECK=1`` with zero findings required (reports at
``LAUNCH_RACECHECK_OUT`` / ``LAUNCH_LEAKCHECK_OUT``); merged metrics at
``LAUNCH_METRICS_OUT``; the report (the phases, each child's device) at
``LAUNCH_REPORT_OUT``.  Exit 0 = drill green.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time

from dmlc_core_tpu_torch.tools._drill import (check, child_device,
                                              gate_checkers, install_checkers,
                                              out)


N_WORKERS = 4
TOTAL_ROUNDS = 10
STRIDE = 2
N_ROWS, N_FEAT = 1500, 8
HOSTS = ["h0", "h1", "h2"]
LOAD_S = 6.0
WORKER_COMMAND = [sys.executable, "-m", "dmlc_core_tpu_torch.tools.check_launch",
                  "--worker"]


def _dataset():
    import numpy as np

    rng = np.random.default_rng(7)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] - 0.5 * X[:, 3] > 0).astype(np.float32)
    return X, y


def _model_kw():
    return dict(n_trees=TOTAL_ROUNDS, max_depth=3, n_bins=16,
                learning_rate=0.3)


# ---------------------------------------------------------------------------
# worker entry (subprocess, spawned by the JobSet)
# ---------------------------------------------------------------------------

def worker_main() -> None:
    from dmlc_core_tpu_torch.base import lockcheck, metrics_agg
    from dmlc_core_tpu_torch.data.iter import ArrayRowIter
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.parallel.recovery import (ElasticSession,
                                                       ElasticTrainer)

    device = child_device()
    # the launch ABI is the whole bootstrap: tracker address from
    # slave_envs(), rank pinned to DMLC_TASK_ID so a respawned attempt
    # reclaims the rank it replaces
    port = int(os.environ["DMLC_TRACKER_PORT"])
    rank = int(os.environ["DMLC_TASK_ID"])
    out_dir = os.environ["LAUNCH_OUT"]
    # DMLC_METRICS_SPOOL arrives via JobSet.worker_env's observability
    # overlay: the spool install exercises that injection path
    metrics_agg.install_spool("launch_worker", rank)
    X, y = _dataset()

    sess = ElasticSession(os.environ["DMLC_TRACKER_URI"], port, rank=rank)
    model = HistGBT(device=device, **_model_kw())
    trainer = ElasticTrainer(model, TOTAL_ROUNDS)  # stride/dir via knobs
    trainer.run(sess,
                lambda lo, hi: ArrayRowIter(X[lo:hi], y[lo:hi]),
                N_ROWS, join_timeout_s=300)
    model.save_model(os.path.join(out_dir, f"model-rank{sess.grank}.gbt"))
    with open(os.path.join(out_dir, f"device-rank{sess.grank}.json"),
              "w") as f:
        json.dump({"device": str(model.device)}, f)
    sess.shutdown()
    lockcheck.check()   # zero lock-order cycles, or die loudly


# ---------------------------------------------------------------------------
# parent: drive the fake cluster
# ---------------------------------------------------------------------------

def _read_models(out_dir):
    got = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("model-rank") and name.endswith(".gbt"):
            with open(os.path.join(out_dir, name), "rb") as f:
                got[name] = f.read()
    return got


def _read_devices(out_dir):
    got = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("device-rank"):
            with open(os.path.join(out_dir, name)) as f:
                got.append(json.load(f)["device"])
    return got


def _metric_total(counter, **labels):
    return sum(s["value"] for s in counter._snap()
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _elastic_fit(device, tmp, tag, fault=""):
    """One supervised 4-rank fit over the fake cluster; returns (model
    bytes, launcher, transport, devices) after asserting clean exits."""
    from dmlc_core_tpu_torch.base import faultinject
    from dmlc_core_tpu_torch.launch import FakeTransport
    from dmlc_core_tpu_torch.parallel.recovery import ElasticLauncher

    out_dir = os.path.join(tmp, f"out-{tag}")
    rec_dir = os.path.join(tmp, f"rec-{tag}")
    os.makedirs(out_dir)
    transport = FakeTransport(hosts=list(HOSTS),
                              log_dir=os.path.join(tmp, f"logs-{tag}"))
    launcher = ElasticLauncher(
        WORKER_COMMAND, N_WORKERS, transport=transport, grace_s=120.0,
        envs={"DMLC_LOCKCHECK": "1", "DMLC_RACECHECK": "1",
              "DRILL_DEVICE": device,
              "DMLC_RECOVERY_DIR": rec_dir,
              "DMLC_RECOVERY_STRIDE": str(STRIDE),
              "DMLC_FAULT_INJECT": "",      # children never inherit ours
              "LAUNCH_OUT": out_dir},
        restart_limit=2, monitor_s=0.05, name=f"elastic-{tag}")
    launcher.launch()
    try:
        if fault:
            # armed once the first stride has committed, so that the
            # host dies mid-fit however fast the workers start (the JAX
            # drill counts 60 supervisor ticks from the launch, which
            # fast workers outrun: the kill then lands after the last
            # commit, or never)
            deadline = time.time() + 600
            while (launcher.tracker.recovery_floor() < STRIDE
                   and time.time() < deadline):
                time.sleep(0.01)
        with faultinject.inject(fault):
            codes = launcher.wait(timeout=900)
    finally:
        launcher.shutdown()
    codes = [codes[r] for r in sorted(codes)]
    check(codes == [0] * N_WORKERS,
           f"{tag}: all {N_WORKERS} ranks finished clean ({codes})")
    models = _read_models(out_dir)
    check(len(models) == N_WORKERS, f"{tag}: {N_WORKERS} ensembles saved")
    blobs = list(models.values())
    check(all(b == blobs[0] for b in blobs),
           f"{tag}: ensembles byte-identical across ranks")
    return (blobs[0], launcher, transport, _read_devices(out_dir),
            os.path.join(out_dir, "model-rank0.gbt"))


def main() -> None:
    if len(sys.argv) >= 2 and sys.argv[1] == "--worker":
        worker_main()
        return
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    from dmlc_core_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(ap.parse_args().device))
    install_checkers()
    # observability plane: JobSet children inherit the spool through
    # worker_env's injection; the parent spools its own registry too
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_launch_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()

    import numpy as np

    from dmlc_core_tpu_torch.base import metrics_agg
    from dmlc_core_tpu_torch.launch import launch_metrics

    spool_writer = metrics_agg.install_spool("drill", 0)
    tmp = tempfile.mkdtemp(prefix="dmlc_launch")
    report = {"device": device, "phases": {}}

    # -- stage 1a: uninterrupted baseline on the fake cluster -----------
    baseline, launcher, _, devs, base_path = _elastic_fit(device, tmp,
                                                          "baseline")
    check(launcher.jobset.respawns() == 0, "baseline: zero respawns")
    st = launcher.jobset.stats()
    check(st["backend"] == "fake" and st["spawns"] == N_WORKERS,
           f"baseline: {N_WORKERS} spawns over the fake transport")
    report["phases"]["baseline"] = {"devices": devs, "model": base_path}

    # -- stage 1b: host h1 dies mid-round; JobSet respawns the rank -----
    blob, launcher, transport, devs, _ = _elastic_fit(
        device, tmp, "chaos", fault="launch_host:kill=h1:n=1")
    check(transport.down_hosts() == ["h1"],
           "chaos: fake host h1 was downed by the injected fault")
    check(launcher.jobset.respawns() >= 1,
           f"chaos: JobSet respawned the lost rank "
           f"({launcher.jobset.respawns()} respawns)")
    ranks = launcher.jobset.stats()["ranks"]
    check(ranks[1]["host"] in ("h0", "h2"),
           f"chaos: rank 1 relanded on a surviving host "
           f"({ranks[1]['host']})")
    kinds = [e["event"] for e in launcher.jobset.events()]
    check("respawn" in kinds and "exit" in kinds,
           "chaos: lifecycle events recorded (exit → respawn)")
    check(_metric_total(launch_metrics()["respawns"]) >= 1,
           "chaos: dmlc_launch_respawns_total counted")
    check(blob == baseline,
           "chaos: recovered ensembles byte-identical to the "
           "uninterrupted baseline")
    report["phases"]["chaos"] = {"devices": devs,
                                 "respawns": launcher.jobset.respawns()}

    # -- stage 2: fleet 2 -> 4 replicas across fake hosts under load ----
    from dmlc_core_tpu_torch.launch import FakeTransport
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.serve import checkpoint_model
    from dmlc_core_tpu_torch.serve.client import ResilientClient
    from dmlc_core_tpu_torch.serve.fleet import (FleetRouter, FleetTracker,
                                                 LauncherScaler, run_loadgen)

    X, y = _dataset()
    m1 = HistGBT(device=device, n_trees=4, max_depth=3, n_bins=16).fit(X, y)
    v1_uri = f"file://{tmp}/v1.ckpt"
    checkpoint_model(v1_uri, m1, version=1)
    expected_npz = os.path.join(tmp, "expected.npz")
    np.savez(expected_npz, X=X, v1=m1.predict(X))

    child_env = {"DMLC_LOCKCHECK": "1", "DMLC_RACECHECK": "1",
                 "DMLC_FAULT_INJECT": "", "FLEET_DEVICE": device}
    tracker = FleetTracker(nworker=8)
    tracker.start()
    fleet_tr = FakeTransport(hosts=["f0", "f1"],
                             log_dir=os.path.join(tmp, "logs-fleet"))
    scaler = LauncherScaler(tracker, v1_uri, transport=fleet_tr,
                            initial=2, spawn_env=child_env)
    router = None

    def _wait(pred, timeout_s, label):
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if pred():
                return
            time.sleep(0.1)
        check(False, f"timed out waiting for {label}")

    try:
        _wait(lambda: len(tracker.serve_endpoints()) == 2,
              180, "initial replica registration")
        check(True, "fleet: 2 launcher-backed replicas registered")
        router = FleetRouter(tracker, probe_s=0.2).start()

        load = {}

        def _loadgen_bg():
            load.update(run_loadgen(
                router.url, expected_npz, duration_s=LOAD_S, procs=2,
                threads=3, base_qps=60.0, timeout_ms=10_000,
                workdir=tmp, env=child_env))

        t = threading.Thread(target=_loadgen_bg)
        t.start()
        time.sleep(LOAD_S / 4.0)
        scaler.scale(1)
        scaler.scale(1)
        _wait(lambda: len(tracker.serve_endpoints()) == 4,
              180, "scaled-out replica registration")
        check(True, "fleet: scaled 2 -> 4 replicas through the JobSet")
        t.join(timeout=LOAD_S + 180)
        check(not t.is_alive(), "fleet: load generator finished")
        check(load.get("dropped") == 0 and load.get("wrong") == 0,
               f"fleet: zero dropped / zero wrong through the scale-out "
               f"({load.get('ok')} ok of {load.get('count')})")
        st = scaler.jobset.stats()
        hosts_used = sorted({r["host"] for r in st["ranks"].values()
                             if r["host"]})
        check(hosts_used == ["f0", "f1"],
               f"fleet: replicas placed across fake hosts {hosts_used}")
        check(st["spawn_ms_p95"] > 0,
               f"fleet: spawn latency recorded "
               f"(p95 {st['spawn_ms_p95']:.1f} ms)")
        replica_devs = sorted(
            ResilientClient(u).healthz().get("device")
            for u in tracker.serve_endpoints().values())
        report["phases"]["fleet"] = {"load": load, "devices": replica_devs,
                                     "hosts": hosts_used}
    finally:
        if router is not None:
            router.close()
        scaler.reap(timeout=15)
        tracker.stop()
    devices = sorted({d for ph in report["phases"].values()
                      for d in ph["devices"]})
    check(devices == [device],
           f"every worker and replica ran on {device} ({devices})")
    report["devices"] = devices

    if spool_writer is not None:
        spool_writer.close()
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("LAUNCH_METRICS_OUT", "launch_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= 2,
           f"metrics spool merged {nprocs} processes (JobSet children "
           f"joined via worker_env injection; artifact at {metrics_out})")
    gate_checkers("LAUNCH")
    report["drill_wall_s"] = time.time() - t_drill0
    report_out = out("LAUNCH_REPORT_OUT", "launch_drill.json")
    with open(report_out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"   report archived to {report_out}")
    print("LAUNCH DRILL GREEN")


if __name__ == "__main__":
    main()
