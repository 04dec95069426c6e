#!/usr/bin/env python
"""Parameter-server chaos drill: SIGKILL a server mid-epoch.

    python -m dmlc_core_tpu_torch.tools.check_ps [--device cpu]

The port of ``scripts/check_ps.py``.  A real multi-process PS job — the
scheduler (hosted by the parent) + 2 server + 3 worker PROCESSES
(``--server`` / ``--worker``, this module) — trains sparse ``GBLinear``
over the dist_async KVStore, twice.  The servers are host processes; the
workers hold their models on the parent's ``--device`` (``DRILL_DEVICE``;
``cuda`` by default), the gradients being host numpy as in JAX:

1. **Baseline** — uninterrupted: every worker converges (train accuracy
   on its own shard above the floor) and exits clean.
2. **Kill/restore** — server 1 runs under the deterministic
   ``ps_push:kill`` fault and SIGKILLs itself mid-epoch.  Workers'
   pushes to that shard fail over (re-resolve through the scheduler
   inside ``DMLC_PS_RECONNECT_S``); the parent respawns the SAME server
   id on the SAME ``DMLC_PS_SNAPSHOT_DIR``, which restores the shard from
   the newest atomic snapshot (vector clock included) and picks the job
   back up.  Every worker must still converge within tolerance of the
   baseline, and the respawned server must report a restore
   (``dmlc_ps_server_restores_total``).

``PS_DRILL_EPOCHS`` (3, the JAX drill's) sets the workers' passes.
Every process runs under ``DMLC_LOCKCHECK=1`` + ``DMLC_RACECHECK=1`` and
verifies zero lock-order cycles; the parent also asserts zero races and
zero live leaks (reports at ``PS_RACECHECK_OUT`` / ``PS_LEAKCHECK_OUT``).
Metrics and trace shards merge at ``PS_METRICS_OUT`` / ``PS_TRACE_OUT``;
GREEN also needs the scorecard ``tools/slo/ps.json`` (the JAX package's
``scripts/slo/ps.json``; scorecard at ``PS_SLO_OUT``); the report at
``PS_DRILL_OUT``.  Exit 0 = both phases green.
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
                                              out, slo_gate)
from dmlc_core_tpu_torch.tools.trace_collect import collect

_HERE = os.path.dirname(os.path.abspath(__file__))

N_SERVERS = 2
N_WORKERS = 3
N_FEATURES = 50_000
ROWS_PER_WORKER = 6_000
NNZ = 16
BATCH_ROWS = 256
#: passes over each worker's shard (``PS_DRILL_EPOCHS``; the tests run 1)
EPOCHS = int(os.environ.get("PS_DRILL_EPOCHS", "3"))
ACC_FLOOR = 0.80          # baseline convergence floor
ACC_TOLERANCE = 0.06      # kill-phase accuracy may trail baseline by this


def _shard_blocks(rank):
    """Deterministic per-worker CSR shard: 64 signal features out of
    50k, shared across ranks so every shard is learnable."""
    import numpy as np

    from dmlc_core_tpu_torch.data.row_block import RowBlock

    sig_rng = np.random.default_rng(7)
    hot = sig_rng.choice(N_FEATURES, 64, replace=False)
    w_true = sig_rng.normal(size=64).astype(np.float32)
    rng = np.random.default_rng(100 + rank)
    blocks = []
    for _ in range(4):
        n = ROWS_PER_WORKER // 4
        idx = rng.integers(0, N_FEATURES, size=(n, NNZ)).astype(np.int64)
        idx[:, :4] = hot[rng.integers(0, 64, size=(n, 4))]
        vals = rng.normal(size=(n, NNZ)).astype(np.float32)
        order = np.argsort(hot)
        pos = order[np.searchsorted(hot[order], idx[:, :4])]
        y = ((vals[:, :4] * w_true[pos]).sum(1) > 0).astype(np.float32)
        off = np.arange(0, n * NNZ + 1, NNZ, dtype=np.int64)
        blocks.append(RowBlock(offset=off, label=y, index=idx.ravel(),
                               value=vals.ravel()))
    return blocks


# ---------------------------------------------------------------------------
# subprocess entries
# ---------------------------------------------------------------------------

def server_main() -> None:
    from dmlc_core_tpu_torch.base import lockcheck
    from dmlc_core_tpu_torch.parallel.ps import PSServer

    port = int(os.environ["PS_SCHED_PORT"])
    srv = PSServer("127.0.0.1", port,
                   server_id=int(os.environ["DMLC_PS_SERVER_ID"]))
    srv.start()
    srv.serve_forever(timeout_s=600)
    stats = os.environ.get("PS_SERVER_STATS")
    if stats:
        with open(stats, "w") as f:
            json.dump({"server_id": srv.server_id,
                       "restored_version": srv.restored_version}, f)
    lockcheck.check()   # zero lock-order cycles, or die loudly


def worker_main() -> None:
    import numpy as np

    from dmlc_core_tpu_torch.base import lockcheck
    from dmlc_core_tpu_torch.models.linear import GBLinear
    from dmlc_core_tpu_torch.parallel.kvstore import DistAsyncKVStore
    from dmlc_core_tpu_torch.parallel.ps import PSClient

    device = child_device()
    rank = int(os.environ["DMLC_TASK_ID"])
    port = int(os.environ["PS_SCHED_PORT"])
    client = PSClient(root_uri="127.0.0.1", root_port=port, rank=rank)
    kv = DistAsyncKVStore(client, learning_rate=0.5, device=device)
    blocks = _shard_blocks(rank)
    model = GBLinear(learning_rate=0.5, reg_lambda=0.0, device=device)
    model.fit_ps(blocks, kv, num_col=N_FEATURES,
                 batch_rows=BATCH_ROWS, n_epochs=EPOCHS)
    # convergence: train accuracy on this worker's own shard
    correct = total = 0
    for blk in blocks:
        rows = np.repeat(np.arange(blk.size), np.diff(blk.offset))
        m = np.zeros(blk.size, np.float32)
        np.add.at(m, rows, model.weights[blk.index] * blk.value)
        m += model.bias
        correct += int(((m > 0) == (blk.label > 0.5)).sum())
        total += blk.size
    samples = kv.staleness_samples
    with open(os.path.join(os.environ["PS_OUT"],
                           f"worker-{rank}.json"), "w") as f:
        json.dump({"rank": rank, "accuracy": correct / total,
                   "staleness_max": max(samples) if samples else 0,
                   "pull_rounds": len(samples),
                   "device": str(model.device)}, f)
    kv.close(shutdown_job=False)    # the parent owns the scheduler
    lockcheck.check()


# ---------------------------------------------------------------------------
# parent: supervise phases
# ---------------------------------------------------------------------------

def _launch(device, role, port, out_dir, snap_dir, server_id=-1, rank=-1,
            fault="", stats=""):
    env = child_env(device,
                    DMLC_FAULT_INJECT=fault,
                    DMLC_PS_SNAPSHOT_DIR=snap_dir,
                    DMLC_PS_SNAPSHOT_STRIDE="1",
                    DMLC_PS_RECONNECT_S="120",
                    DMLC_PS_SERVER_ID=str(server_id),
                    DMLC_TASK_ID=str(rank),
                    PS_SCHED_PORT=str(port),
                    PS_OUT=out_dir,
                    PS_SERVER_STATS=stats)
    return subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.check_ps",
         f"--{role}"], env=env)


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
            check(False, f"{label}: pid {p.pid} hung")


def _worker_stats(out_dir):
    got = {}
    for rank in range(N_WORKERS):
        with open(os.path.join(out_dir, f"worker-{rank}.json")) as f:
            got[rank] = json.load(f)
    return got


def _run_phase(device, label, tmp, fault_sid=None, fault=""):
    """One full PS job; returns per-worker stats + respawn stats."""
    from dmlc_core_tpu_torch.parallel.ps import PSScheduler

    out_dir = os.path.join(tmp, label)
    snap_dir = os.path.join(tmp, f"{label}-snap")
    os.makedirs(out_dir)
    os.makedirs(snap_dir)
    sched = PSScheduler("127.0.0.1", nworker=N_WORKERS, nserver=N_SERVERS)
    sched.start()
    servers = [
        _launch(device, "server", sched.port, out_dir, snap_dir,
                server_id=i, fault=fault if i == fault_sid else "")
        for i in range(N_SERVERS)]
    workers = [_launch(device, "worker", sched.port, out_dir, snap_dir,
                       rank=r) for r in range(N_WORKERS)]

    respawn_stats = None
    if fault_sid is not None:
        victim = servers[fault_sid]
        try:
            victim.wait(timeout=300)
        except subprocess.TimeoutExpired:
            check(False, f"{label}: victim server never died")
        check(victim.returncode == -signal.SIGKILL,
               f"{label}: server {fault_sid} SIGKILLed mid-epoch "
               f"(rc={victim.returncode})")
        stats_path = os.path.join(out_dir, "respawn.json")
        replacement = _launch(device, "server", sched.port, out_dir,
                              snap_dir, server_id=fault_sid,
                              stats=stats_path)
        servers = ([s for s in servers if s is not victim]
                   + [replacement])
        _wait(workers + servers, 600, label)
        with open(stats_path) as f:
            respawn_stats = json.load(f)
    else:
        _wait(workers + servers, 600, label)

    check(all(p.returncode == 0 for p in workers),
           f"{label}: all {N_WORKERS} workers exited clean "
           f"({[p.returncode for p in workers]})")
    check(all(p.returncode == 0 for p in servers),
           f"{label}: surviving servers exited clean "
           f"({[p.returncode for p in servers]})")
    sched.stop()
    return _worker_stats(out_dir), respawn_stats


def main() -> None:
    if len(sys.argv) >= 2 and sys.argv[1] == "--server":
        server_main()
        return
    if len(sys.argv) >= 2 and sys.argv[1] == "--worker":
        worker_main()
        return
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda")
    from dmlc_core_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(ap.parse_args().device))
    # observability plane: scheduler parent, PS servers and workers all
    # spool metrics + trace shards into one directory (children inherit
    # the env through _launch)
    install_checkers(trace=True)
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_ps_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    t_drill0 = time.time()
    from dmlc_core_tpu_torch.base import metrics_agg

    spool_writer = metrics_agg.install_spool("drill", 0)
    tmp = tempfile.mkdtemp(prefix="dmlc_ps_drill")
    staleness_bound = int(os.environ.get("DMLC_PS_STALENESS", 4))

    # -- phase 1: uninterrupted baseline --------------------------------
    base, _ = _run_phase(device, "baseline", tmp)
    for rank, st in base.items():
        check(st["accuracy"] >= ACC_FLOOR,
               f"baseline: worker {rank} converged "
               f"(acc {st['accuracy']:.3f} >= {ACC_FLOOR})")
        check(st["staleness_max"] <= staleness_bound,
               f"baseline: worker {rank} staleness "
               f"{st['staleness_max']} <= bound {staleness_bound}")

    # -- phase 2: SIGKILL server 1 mid-epoch, respawn + restore ---------
    kill, respawn = _run_phase(device, "kill", tmp, fault_sid=1,
                               fault="ps_push:kill:after=40")
    check(respawn is not None and respawn["server_id"] == 1,
           "kill: replacement came back as server 1")
    check(respawn["restored_version"] >= 1,
           f"kill: replacement restored snapshot "
           f"v{respawn['restored_version']} "
           "(dmlc_ps_server_restores_total >= 1)")
    for rank, st in kill.items():
        floor = base[rank]["accuracy"] - ACC_TOLERANCE
        check(st["accuracy"] >= floor,
               f"kill: worker {rank} reconverged through the restore "
               f"(acc {st['accuracy']:.3f} >= baseline - tol {floor:.3f})")
        check(st["staleness_max"] <= staleness_bound,
               f"kill: worker {rank} staleness {st['staleness_max']} "
               f"<= bound {staleness_bound}")
    devices = sorted({st["device"] for stats in (base, kill)
                      for st in stats.values()})
    check(devices == [device],
           f"every worker held its model on {device} ({devices})")

    # -- observability plane: merge spools, stitch the trace -------------
    if spool_writer is not None:
        spool_writer.close()    # final parent snapshot + trace shard
    drill_wall_s = time.time() - t_drill0
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("PS_METRICS_OUT", "ps_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= 3,
           f"metrics spool merged {nprocs} processes "
           f"(artifact at {metrics_out})")
    t_tc0 = time.time()
    trace_out = out("PS_TRACE_OUT", "ps_trace.json")
    _, tsummary = collect(spool, trace_out)
    trace_collect_s = time.time() - t_tc0
    cross = {tid: t for tid, t in tsummary["traces"].items()
             if len(t["pids"]) >= 2 and "ps.push" in t["spans"]
             and "ps.server.push" in t["spans"]}
    check(cross,
           f"{len(cross)} trace(s) followed a push worker -> server "
           f"across processes (merged Perfetto trace at {trace_out})")

    rc_report, lk_report = gate_checkers("PS")

    # -- SLO scorecard gate ----------------------------------------------
    evidence = {
        "workers": {
            "min_accuracy": min(st["accuracy"] for st in base.values()),
            "staleness_max": max(st["staleness_max"]
                                 for stats in (base, kill)
                                 for st in stats.values()),
        },
        "respawn": respawn,
        "racecheck": {"races": len(rc_report["races"])},
        "leakcheck": {"leaks": len(lk_report["leaks"])},
    }
    scorecard = slo_gate("ps", "PS", merged, evidence, _HERE)
    report_out = out("PS_DRILL_OUT", "ps_drill.json")
    with open(report_out, "w") as f:
        json.dump({
            "device": device, "devices": devices,
            "baseline": base, "kill": kill, "respawn": respawn,
            "observability": {
                "spool_processes_merged": nprocs,
                "traces": len(tsummary["traces"]),
                "cross_process_traces": len(cross),
                "trace_collect_s": round(trace_collect_s, 3),
                "drill_wall_s": round(drill_wall_s, 3),
            },
            "slo": scorecard,
        }, f, indent=2)
    print(f"   report archived to {report_out}")
    print("PS CHAOS DRILL GREEN")


if __name__ == "__main__":
    main()
