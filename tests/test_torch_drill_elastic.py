"""``python -m dmlc_core_tpu_torch.tools.check_elastic --device cpu``: the
baseline, rejoin and evict phases over 4 worker processes and an
``ElasticTracker``, every verdict of ``scripts/check_elastic.py`` green —
the rejoined ensembles byte-identical to the baseline — and the baseline
ensemble held at parity level (b) against the JAX package's one-process
fit of the same rows."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_drills import checks, run_drill  # noqa: E402
from _torch_parity import assert_level_b  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch.models import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.tools import check_elastic  # noqa: E402

VERDICTS = (
    "baseline: ensembles byte-identical across workers",
    "rejoin: victim SIGKILLed mid-round (rc=-9)",
    "rejoin: recovered ensembles byte-identical to baseline",
    "rejoin: recovery floor reached 12",
    "rejoin: dmlc_worker_deaths_total{outcome=rejoined} counted",
    "evict: survivors agree byte-for-byte after the re-shard",
    "evict: dmlc_elastic_reshards_total counted",
    "every worker boosted on cpu", "zero lock-order cycles",
    "zero happens-before races", "zero live resource leaks")


def test_elastic_drill_is_green_and_meets_level_b(tmp_path):
    res = run_drill("elastic", tmp_path, outs=(
        "ELASTIC_REPORT_OUT", "ELASTIC_METRICS_OUT",
        "ELASTIC_RACECHECK_OUT", "ELASTIC_LEAKCHECK_OUT"))
    assert res.returncode == 0, (checks(res)[-4:], res.stderr[-3000:])
    assert res.stdout.splitlines()[-1] == "ELASTIC CHAOS DRILL GREEN"
    got = checks(res)
    assert all(ln.startswith("ok:") for ln in got), got
    for verdict in VERDICTS:
        assert any(verdict in ln for ln in got), (verdict, got)
    report = json.loads((tmp_path / "elastic_report_out.json").read_text())
    assert report["devices"] == ["cpu"]
    assert sorted(report["phases"]) == ["baseline", "evict", "rejoin"]
    assert len(report["phases"]["rejoin"]["workers"]) == 4
    assert len(report["phases"]["evict"]["workers"]) == 3
    # the drill's ensemble is the bytes of a one-process fit with its
    # cuts, whose fit (train margins included) stands for it against JAX
    path = report["phases"]["baseline"]["model"]
    cuts = HistGBT.load_model(path, device="cpu").cuts.numpy()
    X, y = check_elastic._dataset()
    tm = HistGBT(device="cpu", **check_elastic._model_kw()).fit(X, y, cuts=cuts)
    tm.save_model(str(tmp_path / "one.model"))
    with open(path, "rb") as f:
        assert (tmp_path / "one.model").read_bytes() == f.read()
    jm = JaxHistGBT(mesh=local_mesh(1), **check_elastic._model_kw()).fit(
        X, y, cuts=cuts)
    assert len(tm.trees) == len(jm.trees) == check_elastic.TOTAL_ROUNDS
    assert_level_b(jm, tm, X, X=X, y=y)


def _finished_job_then_late_rejoin(mod, timeout_s):
    """Two ranks join, commit round 3 and finish (rank 1's session drops
    as a SIGKILL after its last commit would, rank 0 shuts down); then
    rank 1 rejoins.  Returns its join's reply or the error it raised."""
    import threading

    tracker = mod.ElasticTracker(nworker=2, grace_s=60.0)
    tracker.start()
    try:
        s0 = mod.ElasticSession("127.0.0.1", tracker.port)
        s1 = mod.ElasticSession("127.0.0.1", tracker.port)
        threads = [threading.Thread(target=lambda s=s: (s.join(30),
                                                        s.commit(3)))
                   for s in (s0, s1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        rank1 = s1.grank
        s1.close()
        s0.shutdown()
        late = mod.ElasticSession("127.0.0.1", tracker.port, rank=rank1)
        try:
            return late.join(timeout_s=timeout_s)
        except Exception as e:  # noqa: BLE001 — the reference's outcome
            return e
        finally:
            late.close()
    finally:
        tracker.stop()


def test_a_rank_respawned_after_the_job_finished_restores_and_stops():
    # ROADMAP C22: a host killed between a rank's last commit and its exit
    # respawns the rank into a job whose other ranks have shut down; the
    # JAX package's tracker lets it wait out the join timeout (the launch
    # drill hung at its time limit), the port's answers "done" at once
    from dmlc_core_tpu.parallel import recovery as jax_recovery
    from dmlc_core_tpu_torch.parallel import recovery as port_recovery

    got = _finished_job_then_late_rejoin(jax_recovery, 2.0)
    assert isinstance(got, Exception) and "join timeout" in str(got)
    got = _finished_job_then_late_rejoin(port_recovery, 30.0)
    assert got["done"] and got["floor"] == 3 and got["world"] == 1
