#!/usr/bin/env python
"""Elastic-recovery chaos drill: SIGKILL a worker mid-boost.

    python -m dmlc_core_tpu_torch.tools.check_elastic [--device cpu]

The port of ``scripts/check_elastic.py``.  Three phases over 4 local
worker PROCESSES (``--worker``, this module) coordinated by an
``ElasticTracker`` (the tracker-hub host collectives, rabit's wire role),
each worker boosting on its device (``DRILL_DEVICE``: the parent's
``--device``, ``cuda`` by default):

1. **Baseline** — an uninterrupted 4-worker data-parallel run over row
   shards; all four ensembles must agree byte for byte.
2. **Rejoin** — the same job, but one worker is SIGKILLed mid-round by
   the deterministic ``allreduce:kill`` fault.  Survivors abort the
   in-flight round and roll back to the recovery floor; the parent
   relaunches the dead rank, which catches up from the floor checkpoint;
   the finished ensembles must be byte-identical to the baseline (the
   port's integer-atomic histograms make every replay byte-stable).
3. **Evict** — elastic mode, short grace: the victim dies at a commit
   boundary (``worker:kill``) and is NOT replaced.  Once its grace lapses
   the tracker re-forms the epoch over the 3 survivors,
   ``shard_row_ranges`` re-cuts the rows, and the job converges with a
   loss within 1% of the baseline.

Every process runs under ``DMLC_LOCKCHECK=1`` + ``DMLC_RACECHECK=1`` and
verifies zero lock-order cycles; the parent also asserts zero races
(report at ``ELASTIC_RACECHECK_OUT``) and zero live leaks
(``ELASTIC_LEAKCHECK_OUT``).  The recovery metrics
(``dmlc_worker_deaths_total{outcome}``, ``dmlc_elastic_reshards_total``)
are asserted on the tracker registry; merged metrics at
``ELASTIC_METRICS_OUT``; the report (each phase's workers, their
devices) at ``ELASTIC_REPORT_OUT``.  Exit 0 = all phases green.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from dmlc_core_tpu_torch.tools._drill import (check, child_device, child_env,
                                              gate_checkers, install_checkers,
                                              out)


N_WORKERS = 4
TOTAL_ROUNDS = 12
STRIDE = 3
N_ROWS, N_FEAT = 2000, 8


def _model_kw():
    return dict(n_trees=TOTAL_ROUNDS, max_depth=3, n_bins=16,
                learning_rate=0.3)


def _dataset():
    import numpy as np

    rng = np.random.default_rng(42)
    X = rng.normal(size=(N_ROWS, N_FEAT)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] - 0.5 * X[:, 3] > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# worker entry (subprocess)
# ---------------------------------------------------------------------------

def worker_main() -> None:
    from dmlc_core_tpu_torch.base import lockcheck, metrics_agg
    from dmlc_core_tpu_torch.data.iter import ArrayRowIter
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.parallel.recovery import (ElasticSession,
                                                       ElasticTrainer)

    device = child_device()
    port = int(os.environ["ELASTIC_TRACKER_PORT"])
    out_dir = os.environ["ELASTIC_OUT"]
    rank = int(os.environ.get("ELASTIC_RANK", "-1"))
    metrics_agg.install_spool("elastic_worker", max(rank, 0))
    X, y = _dataset()

    sess = ElasticSession("127.0.0.1", port, rank=rank)
    model = HistGBT(device=device, **_model_kw())
    trainer = ElasticTrainer(model, TOTAL_ROUNDS)  # stride/dir via knobs
    trainer.run(sess,
                lambda lo, hi: ArrayRowIter(X[lo:hi], y[lo:hi]),
                N_ROWS, join_timeout_s=300)
    model.save_model(os.path.join(out_dir, f"model-rank{sess.grank}.gbt"))
    with open(os.path.join(out_dir, f"stats-rank{sess.grank}.json"),
              "w") as f:
        json.dump({"rounds_replayed": trainer.rounds_replayed,
                   "resumed_from": trainer.resumed_from,
                   "device": str(model.device)}, f)
    sess.shutdown()
    lockcheck.check()   # zero lock-order cycles, or die loudly


# ---------------------------------------------------------------------------
# parent: supervise phases
# ---------------------------------------------------------------------------

def _launch(device, port, out_dir, rec_dir, rank=-1, fault=""):
    env = child_env(device,
                    DMLC_RECOVERY_DIR=rec_dir,
                    DMLC_RECOVERY_STRIDE=str(STRIDE),
                    DMLC_FAULT_INJECT=fault,
                    ELASTIC_TRACKER_PORT=str(port),
                    ELASTIC_OUT=out_dir,
                    ELASTIC_RANK=str(rank))
    return subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.check_elastic",
         "--worker"], env=env)


def _wait(procs, timeout_s, label):
    deadline = time.time() + timeout_s
    for p in procs:
        left = max(1.0, deadline - time.time())
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
            check(False, f"{label}: worker pid {p.pid} hung")


def _read_models(out_dir):
    got = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("model-rank") and name.endswith(".gbt"):
            with open(os.path.join(out_dir, name), "rb") as f:
                got[name] = f.read()
    return got


def _worker_stats(out_dir):
    got = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("stats-rank"):
            with open(os.path.join(out_dir, name)) as f:
                got[name[len("stats-"):-len(".json")]] = json.load(f)
    return got


def _loss_of(blob, device):
    import torch

    from dmlc_core_tpu_torch.io.stream import Stream
    from dmlc_core_tpu_torch.models import HistGBT

    uri = f"mem://elastic/{time.time_ns()}"
    with Stream.create(uri, "w") as s:
        s.write(blob)
    m = HistGBT.load_model(uri, device=device)
    X, y = _dataset()
    margins = m.predict(X, output_margin=True)
    return float(m._obj.metric(torch.as_tensor(margins),
                               torch.as_tensor(y)))


def _metric_total(counter, **labels):
    return sum(s["value"] for s in counter._snap()
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def main() -> None:
    if len(sys.argv) >= 2 and sys.argv[1] == "--worker":
        worker_main()
        return
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    from dmlc_core_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(ap.parse_args().device))
    install_checkers()
    # observability plane: parent + worker subprocesses spool metrics
    # snapshots into one directory (children inherit the env)
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_elastic_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()

    from dmlc_core_tpu_torch.base import metrics_agg
    from dmlc_core_tpu_torch.base.metrics import default_registry
    from dmlc_core_tpu_torch.parallel.recovery import ElasticTracker

    spool_writer = metrics_agg.install_spool("drill", 0)
    reg = default_registry()
    deaths = reg.counter("worker_deaths_total", labels=("outcome",))
    reshards = reg.counter("elastic_reshards_total")
    tmp = tempfile.mkdtemp(prefix="dmlc_elastic")
    report = {"device": device, "phases": {}}

    # -- phase 1: uninterrupted baseline --------------------------------
    out1, rec1 = os.path.join(tmp, "out1"), os.path.join(tmp, "rec1")
    os.makedirs(out1)
    tracker = ElasticTracker(nworker=N_WORKERS, grace_s=120.0)
    tracker.start()
    procs = [_launch(device, tracker.port, out1, rec1)
             for _ in range(N_WORKERS)]
    _wait(procs, 600, "baseline")
    tracker.stop()
    check(all(p.returncode == 0 for p in procs),
           f"baseline: all {N_WORKERS} workers exited clean "
           f"({[p.returncode for p in procs]})")
    models = _read_models(out1)
    check(len(models) == N_WORKERS, f"baseline: {N_WORKERS} ensembles")
    blobs = list(models.values())
    check(all(b == blobs[0] for b in blobs),
           "baseline: ensembles byte-identical across workers")
    baseline = blobs[0]
    base_loss = _loss_of(baseline, device)
    print(f"   baseline eval loss {base_loss:.5f}")
    report["phases"]["baseline"] = {
        "workers": _worker_stats(out1), "loss": base_loss,
        "model": os.path.join(out1, sorted(models)[0])}

    # -- phase 2: SIGKILL mid-round, rejoin, byte parity ----------------
    out2, rec2 = os.path.join(tmp, "out2"), os.path.join(tmp, "rec2")
    os.makedirs(out2)
    tracker = ElasticTracker(nworker=N_WORKERS, grace_s=120.0)
    tracker.start()
    procs = [_launch(device, tracker.port, out2, rec2,
                     fault="allreduce:kill:after=37" if i == 1 else "")
             for i in range(N_WORKERS)]
    victim = procs[1]
    try:
        victim.wait(timeout=300)
    except subprocess.TimeoutExpired:
        check(False, "rejoin: victim was never killed")
    check(victim.returncode == -signal.SIGKILL,
           f"rejoin: victim SIGKILLed mid-round (rc={victim.returncode})")
    deadline = time.time() + 60
    while time.time() < deadline and not tracker.lost_ranks():
        time.sleep(0.05)
    lost = tracker.lost_ranks()
    check(len(lost) == 1, f"rejoin: tracker holds rank {lost} in grace")
    replacement = _launch(device, tracker.port, out2, rec2, rank=lost[0])
    _wait([p for p in procs if p is not victim] + [replacement],
          600, "rejoin")
    tracker.stop()
    rcs = [p.returncode for p in procs if p is not victim] + [
        replacement.returncode]
    check(all(rc == 0 for rc in rcs),
           f"rejoin: survivors + rejoiner exited clean ({rcs})")
    models = _read_models(out2)
    check(len(models) == N_WORKERS,
           f"rejoin: all {N_WORKERS} ranks finished")
    check(all(b == baseline for b in models.values()),
           "rejoin: recovered ensembles byte-identical to baseline")
    check(tracker.recovery_floor() == TOTAL_ROUNDS,
           f"rejoin: recovery floor reached {TOTAL_ROUNDS}")
    check(_metric_total(deaths, outcome="rejoined") >= 1,
           "rejoin: dmlc_worker_deaths_total{outcome=rejoined} counted")
    report["phases"]["rejoin"] = {"workers": _worker_stats(out2),
                                  "lost": lost}

    # -- phase 3: SIGKILL at a commit, evict + elastic re-shard ----------
    out3, rec3 = os.path.join(tmp, "out3"), os.path.join(tmp, "rec3")
    os.makedirs(out3)
    tracker = ElasticTracker(nworker=N_WORKERS, grace_s=1.5, elastic=True)
    tracker.start()
    procs = [_launch(device, tracker.port, out3, rec3,
                     fault="worker:kill:after=2" if i == 2 else "")
             for i in range(N_WORKERS)]
    victim = procs[2]
    _wait([victim], 300, "evict")
    check(victim.returncode == -signal.SIGKILL,
           f"evict: victim SIGKILLed at a commit (rc={victim.returncode})")
    _wait([p for p in procs if p is not victim], 600, "evict")
    tracker.stop()
    check(all(p.returncode == 0 for p in procs if p is not victim),
           "evict: survivors exited clean")
    models = _read_models(out3)
    check(len(models) == N_WORKERS - 1,
           f"evict: {N_WORKERS - 1} survivor ensembles")
    blobs = list(models.values())
    check(all(b == blobs[0] for b in blobs),
           "evict: survivors agree byte-for-byte after the re-shard")
    evict_loss = _loss_of(blobs[0], device)
    rel = abs(evict_loss - base_loss) / max(base_loss, 1e-9)
    check(rel < 0.01,
           f"evict: loss {evict_loss:.5f} within 1% of baseline "
           f"{base_loss:.5f} (rel {rel:.4f})")
    check(_metric_total(reshards) >= 1,
           "evict: dmlc_elastic_reshards_total counted")
    check(_metric_total(deaths, outcome="evicted") >= 1,
           "evict: dmlc_worker_deaths_total{outcome=evicted} counted")
    report["phases"]["evict"] = {"workers": _worker_stats(out3),
                                 "loss": evict_loss}
    devices = sorted({w["device"] for ph in report["phases"].values()
                      for w in ph["workers"].values()})
    check(devices == [device],
           f"every worker boosted on {device} ({devices})")
    report["devices"] = devices

    if spool_writer is not None:
        spool_writer.close()
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("ELASTIC_METRICS_OUT", "elastic_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= 1, f"metrics spool merged {nprocs} processes "
                        f"(artifact at {metrics_out})")
    gate_checkers("ELASTIC")
    report["drill_wall_s"] = time.time() - t_drill0
    report_out = out("ELASTIC_REPORT_OUT", "elastic_drill.json")
    with open(report_out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"   report archived to {report_out}")
    print("ELASTIC CHAOS DRILL GREEN")


if __name__ == "__main__":
    main()
