"""Elastic recovery: kill a worker mid-fit, relaunch, resume, match.

    python -m dmlc_core_tpu_torch.examples.elastic_recovery [--device cpu]

The port of ``examples/elastic_recovery.py``: the composition of three
mechanisms, end to end on real processes —

* the tracker notices a dead worker and frees its rank (the
  :class:`RabitTracker`'s liveness over each worker's persistent
  :class:`WorkerSession`);
* the cluster manager relaunches the attempt with a bumped
  ``DMLC_NUM_ATTEMPT`` (the YARN ApplicationMaster's restart counting);
* the restarted worker reclaims its rank (``cmd=recover``) and reloads
  the model, so training continues instead of starting over.

1. an "application master" loop launches 2 workers (``--worker``, this
   module) through the ``DMLC_*`` env ABI; one ``RabitTracker`` serves
   every attempt;
2. each worker joins a ``torch.distributed`` group (gloo: the workers
   share one card) at a fresh rendezvous port per attempt, and trains a
   data-parallel ``HistGBT`` in 4 segments of 4 trees (a continued fit a
   segment), rank 0 checkpointing after each (atomic meta rename, then a
   barrier);
3. on attempt 0, worker 1 SIGKILLs itself mid-fit, between dispatch
   chunks of segment 2;
4. the AM reaps the -9, kills the survivor, bumps ``DMLC_NUM_ATTEMPT``
   and relaunches; both ranks come back through ``recover``;
5. attempt 1 resumes from the last durable checkpoint and finishes;
6. the final model equals an uninterrupted run of the same 2-process job
   tree for tree.

``--smoke`` changes nothing (the run is already small).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from dmlc_core_tpu_torch.examples import _cli

SEGS = 4            # checkpoint segments
SEG_TREES = 4       # boosting rounds per segment
KILL_SEG = 2        # worker 1 dies inside this segment's fit (attempt 0)
N_BINS = 32
KW = dict(max_depth=3, n_bins=N_BINS, learning_rate=0.5, n_trees=SEG_TREES)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_data():
    import numpy as np
    rng = np.random.default_rng(42)
    X = rng.normal(size=(512, 8)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

def worker_main(device):
    import torch

    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.ops.quantile import compute_cuts
    from dmlc_core_tpu_torch.parallel import collectives as coll
    from dmlc_core_tpu_torch.tracker.tracker import WorkerSession

    task = int(os.environ["DMLC_TASK_ID"])
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    ckdir = os.environ["DRILL_CKPT_DIR"]
    kill_seg = int(os.environ.get("DRILL_KILL_SEG", "-1"))
    uri = os.environ["DMLC_TRACKER_URI"]
    legacy_port = int(os.environ["DMLC_LEGACY_TRACKER_PORT"])

    # the tracker session: a fresh rank on attempt 0, the freed rank
    # reclaimed on a restart (the rabit recover path)
    if attempt == 0:
        ws = WorkerSession(uri, legacy_port, host=f"host{task}")
    else:
        ws = WorkerSession(uri, legacy_port, cmd="recover", rank=task)
        assert ws.info["rank"] == task, ws.info

    coll.init(backend="gloo")

    class KillableGBT(HistGBT):
        """SIGKILL between dispatch chunks of one fit(): a genuine
        mid-fit crash (the segment's trees partly fetched, its
        checkpoint not yet written)."""
        kill_at_chunk = -1

        def _boost(self, *a, **kw):
            seen = {"n": 0}

            def cb(rounds_fetched, elapsed_s):
                seen["n"] += 1
                if seen["n"] == self.kill_at_chunk:
                    ws.print_msg(f"worker {task}: SIGKILL mid-fit "
                                 f"(chunk {seen['n']})")
                    os.kill(os.getpid(), signal.SIGKILL)

            kw["chunk_callback"] = cb
            return super()._boost(*a, **kw)

    X, y = make_data()
    cuts = compute_cuts(torch.from_numpy(X).to(device), N_BINS)
    meta_path = os.path.join(ckdir, "meta.json")
    start_seg = 0
    model = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            start_seg = json.load(f)["segments_done"]
        model = HistGBT.load_model(
            os.path.join(ckdir, f"seg{start_seg}.bin"), device=device)
        model.param.init({"n_trees": SEG_TREES})
        ws.print_msg(f"worker {task}: resumed at segment {start_seg} "
                     f"({len(model.trees)} trees)")

    for seg in range(start_seg, SEGS):
        if model is None:
            model = KillableGBT(device=device, **KW)
            if attempt == 0 and task == 1 and seg == kill_seg:
                model.kill_at_chunk = 2
            model.fit(X, y, cuts=cuts)
        else:
            if isinstance(model, KillableGBT):
                model.kill_at_chunk = (
                    2 if attempt == 0 and task == 1 and seg == kill_seg
                    else -1)
            model.fit(X, y)                  # continued fit, cuts kept
        if coll.rank() == 0:
            model.save_model(os.path.join(ckdir, f"seg{seg + 1}.bin"))
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"segments_done": seg + 1}, f)
            os.replace(tmp, meta_path)       # atomic: no torn meta
        coll.barrier()                       # checkpoint durable for all
        ws.print_msg(f"worker {task}: segment {seg + 1}/{SEGS} done")

    if coll.rank() == 0:
        model.save_model(os.path.join(ckdir, "final.bin"))
        with open(os.path.join(ckdir, "device.json"), "w") as f:
            json.dump({"device": str(model.device)}, f)
    coll.barrier()
    ws.shutdown()
    coll.finalize()


# ---------------------------------------------------------------------------
# application-master side
# ---------------------------------------------------------------------------

def run_drill(ckdir, device, kill=True, max_attempts=3, timeout=600):
    """Run the whole drill; returns a report dict.  ``kill=False`` runs
    the same gang and segments with no crash (the comparator)."""
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker, _free_port

    os.makedirs(ckdir, exist_ok=True)
    tracker = RabitTracker(host_ip="127.0.0.1", nworker=2)
    tracker.start()
    report = {"attempts": [], "dead_seen": [], "recovered": False}
    try:
        for attempt in range(max_attempts):
            env = dict(os.environ)
            env.update({
                "DMLC_NUM_WORKER": "2",
                "DMLC_NUM_SERVER": "0",
                "DMLC_TRACKER_URI": "127.0.0.1",
                # a fresh rendezvous port per attempt (the previous
                # attempt's store died with worker 0)
                "DMLC_TRACKER_PORT": str(_free_port("127.0.0.1")),
                "DMLC_LEGACY_TRACKER_PORT": str(tracker.port),
                "DMLC_NUM_ATTEMPT": str(attempt),
                "DMLC_ROLE": "worker",
                "DRILL_CKPT_DIR": ckdir,
                "DRILL_KILL_SEG": str(KILL_SEG if kill else -1),
                "PYTHONPATH": ROOT,
                # several dispatch chunks a segment, so that "mid-fit"
                # (between chunks) is a real interior point
                "DMLC_TPU_ROUNDS_PER_DISPATCH": "2",
            })
            procs = []
            for task in range(2):
                e = dict(env)
                e["DMLC_TASK_ID"] = str(task)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "dmlc_core_tpu_torch.examples.elastic_recovery",
                     "--worker", "--device", device], env=e))
            deadline = time.monotonic() + timeout
            codes = [None, None]
            failed = False
            while any(c is None for c in codes):
                if time.monotonic() > deadline:
                    for p in procs:
                        p.kill()
                        p.wait()
                    raise TimeoutError("drill attempt timed out")
                for i, p in enumerate(procs):
                    if codes[i] is None and p.poll() is not None:
                        codes[i] = p.returncode
                        if p.returncode != 0 and not failed:
                            failed = True
                            # YARN AM semantics: one container down,
                            # abort-kill the gang, count the attempt
                            for q in procs:
                                if q.poll() is None:
                                    q.kill()
                time.sleep(0.05)
            report["attempts"].append({"attempt": attempt, "codes": codes})
            if not failed:
                report["recovered"] = attempt > 0
                break
            # liveness: the tracker must have noticed the deaths and
            # freed the ranks before the relaunch reclaims them
            t0 = time.monotonic()
            while time.monotonic() - t0 < 10:
                if len(tracker.dead_workers) >= 2:
                    break
                time.sleep(0.05)
            report["dead_seen"] = sorted(set(tracker.dead_workers))
        else:
            raise RuntimeError(f"drill failed all {max_attempts} attempts: "
                               f"{report}")
    finally:
        tracker.stop()
    report["final_model"] = os.path.join(ckdir, "final.bin")
    with open(os.path.join(ckdir, "device.json")) as f:
        report["device"] = json.load(f)["device"]
    return report


def main(argv=None):
    args = _cli.parse(__doc__, argv, worker=True)
    device = args.device
    if args.worker:
        worker_main(device)
        return 0

    import numpy as np

    from dmlc_core_tpu_torch.models import HistGBT

    with tempfile.TemporaryDirectory() as killed_dir, \
            tempfile.TemporaryDirectory() as clean_dir:
        report = run_drill(killed_dir, args.device, kill=True)
        print(f"attempts: {report['attempts']}")
        print(f"tracker saw dead ranks: {report['dead_seen']}")
        assert report["recovered"], "expected a restart to happen"

        # the comparator: the SAME 2-process job, never killed (every
        # segment replays through the same continued-fit path either
        # way, so the crash must be invisible in the result)
        clean = run_drill(clean_dir, args.device, kill=False)
        assert clean["attempts"] == [{"attempt": 0, "codes": [0, 0]}], clean

        recovered = HistGBT.load_model(report["final_model"], device=device)
        ref = HistGBT.load_model(clean["final_model"], device=device)
        assert len(recovered.trees) == len(ref.trees) == SEGS * SEG_TREES
        for i, (tr, tf) in enumerate(zip(recovered.trees, ref.trees)):
            assert np.array_equal(tr["feat"], tf["feat"]), i
            assert np.array_equal(tr["thr"], tf["thr"]), i
            np.testing.assert_array_equal(tr["leaf"], tf["leaf"])
        with open(report["final_model"], "rb") as f, \
                open(clean["final_model"], "rb") as g:
            assert f.read() == g.read(), "model files differ"
        X, y = make_data()
        np.testing.assert_array_equal(recovered.predict(X), ref.predict(X))
        acc = ((recovered.predict(X) > 0.5) == y).mean()
        print(f"workers on {report['device']}; recovered model == "
              f"uninterrupted model, bit-exact ({len(ref.trees)} trees, "
              f"train acc {acc:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
