"""``python -m dmlc_core_tpu_torch.tools.check_launch --device cpu``: an
elastic fit under host death on a 3-host ``FakeTransport`` (the respawned
rank's ensembles byte-identical to the uninterrupted baseline), then
fleet scale-out through ``LauncherScaler`` under verified load (zero
dropped, zero wrong); every verdict of ``scripts/check_launch.py``
green, and the baseline ensemble held at parity level (b) against the
JAX package's one-process fit of the same rows."""

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
from dmlc_core_tpu_torch.tools import check_launch  # noqa: E402

VERDICTS = (
    "baseline: zero respawns", "baseline: 4 spawns over the fake transport",
    "chaos: fake host h1 was downed by the injected fault",
    "chaos: JobSet respawned the lost rank",
    "chaos: rank 1 relanded on a surviving host",
    "chaos: recovered ensembles byte-identical to the uninterrupted baseline",
    "fleet: scaled 2 -> 4 replicas through the JobSet",
    "fleet: zero dropped / zero wrong through the scale-out",
    "fleet: replicas placed across fake hosts ['f0', 'f1']",
    "every worker and replica ran on cpu", "zero lock-order cycles",
    "zero happens-before races", "zero live resource leaks")


def test_launch_drill_is_green_and_meets_level_b(tmp_path):
    res = run_drill("launch", tmp_path, outs=(
        "LAUNCH_REPORT_OUT", "LAUNCH_METRICS_OUT", "LAUNCH_RACECHECK_OUT",
        "LAUNCH_LEAKCHECK_OUT"))
    assert res.returncode == 0, (checks(res)[-4:], res.stderr[-3000:])
    assert res.stdout.splitlines()[-1] == "LAUNCH DRILL GREEN"
    got = checks(res)
    assert all(ln.startswith("ok:") for ln in got), got
    for verdict in VERDICTS:
        assert any(verdict in ln for ln in got), (verdict, got)
    report = json.loads((tmp_path / "launch_report_out.json").read_text())
    assert report["devices"] == ["cpu"]
    load = report["phases"]["fleet"]["load"]
    assert load["dropped"] == 0 and load["wrong"] == 0 and load["ok"] > 0
    assert report["phases"]["chaos"]["respawns"] >= 1
    # the drill's ensemble is the bytes of a one-process fit with its
    # cuts, whose fit (train margins included) stands for it against JAX
    path = report["phases"]["baseline"]["model"]
    cuts = HistGBT.load_model(path, device="cpu").cuts.numpy()
    X, y = check_launch._dataset()
    tm = HistGBT(device="cpu", **check_launch._model_kw()).fit(X, y, cuts=cuts)
    tm.save_model(str(tmp_path / "one.model"))
    with open(path, "rb") as f:
        assert (tmp_path / "one.model").read_bytes() == f.read()
    jm = JaxHistGBT(mesh=local_mesh(1), **check_launch._model_kw()).fit(
        X, y, cuts=cuts)
    assert len(tm.trees) == len(jm.trees) == check_launch.TOTAL_ROUNDS
    assert_level_b(jm, tm, X, X=X, y=y)


class _Tracker:
    """A tracker whose ``lost_ranks`` the test scripts: rank 0 is held as
    lost from ``lost_from`` seconds after construction on."""

    def __init__(self, lost_from):
        import time

        self._t0 = time.monotonic()
        self._lost_from = lost_from

    def lost_ranks(self):
        import time

        return [0] if time.monotonic() - self._t0 >= self._lost_from else []


def _one_rank_run(mod, lost_from):
    """One rank sleeping 2.5 s under a JobSet cross-checked (every 50 ms,
    25 cycles: 1.25 s) against a scripted tracker; ``(code, events)``."""
    js = mod.JobSet([sys.executable, "-c", "import time; time.sleep(2.5)"],
                    1, transport=mod.LocalTransport(), restart_limit=0,
                    monitor_s=0.05, tracker=_Tracker(lost_from),
                    name="wedge")
    codes = js.run(timeout=60)
    return codes[0], [e["event"] for e in js.events()]


def test_a_starting_attempt_is_not_killed_as_wedged(monkeypatch):
    # ROADMAP C21: a respawn starts while the tracker still holds its
    # predecessor as lost; the JAX package's JobSet kills it as wedged
    # once the wedge window passes, before it could reconnect (the launch
    # drill's rank 1, three times, on a loaded host); the port's counts
    # only an attempt the tracker has held as live
    from dmlc_core_tpu import launch as jax_launch
    from dmlc_core_tpu_torch import launch as port_launch

    monkeypatch.setenv("DMLC_LAUNCH_WEDGE_CYCLES", "25")
    code, events = _one_rank_run(jax_launch, lost_from=0.0)
    assert code == -9 and "wedged" in events
    code, events = _one_rank_run(port_launch, lost_from=0.0)
    assert code == 0 and "wedged" not in events
    # an attempt the tracker held as live and then lost is still killed
    code, events = _one_rank_run(port_launch, lost_from=0.5)
    assert code == -9 and "wedged" in events


def _teardown_during_a_slow_respawn(mod):
    """A rank crashes, and its respawn's spawn takes 2 s (the fork of a
    large parent on a loaded host); ``shutdown`` is called meanwhile.
    Returns (supervisor alive after shutdown, the respawn's process)."""
    import threading
    import time

    started = threading.Event()
    spawned = []

    class SlowRespawns(mod.LocalTransport):
        def spawn(self, command, env, host, label="worker"):
            if env.get("DMLC_NUM_ATTEMPT") != "0":
                started.set()
                time.sleep(2.0)
            handle = super().spawn(command, env, host, label=label)
            spawned.append(handle)
            return handle

    code = ("import os, sys, time\n"
            "time.sleep(0.2 if os.environ['DMLC_NUM_ATTEMPT'] == '0' else 30)\n"
            "sys.exit(3)\n")
    js = mod.JobSet([sys.executable, "-c", code], 1,
                    transport=SlowRespawns(), restart_limit=2, monitor_s=0.05,
                    name="slow-respawn")
    js.launch()
    assert started.wait(30)
    js.shutdown(graceful_s=1.0)
    alive = js._thread.is_alive()
    js._thread.join(10)
    return alive, spawned[-1].proc


def test_teardown_waits_for_the_supervisors_last_step(monkeypatch):
    # ROADMAP C23: JAX's JobSet.shutdown waits 1 s for its supervisor;
    # a respawn in flight then lands after the teardown and its worker
    # outlives it (the card's prodsim drill: the supervisor thread alive
    # at the leak gate, a replica left running); the port's waits
    from dmlc_core_tpu import launch as jax_launch
    from dmlc_core_tpu_torch import launch as port_launch

    monkeypatch.setenv("DMLC_RETRY_BASE_S", "0.01")
    alive, proc = _teardown_during_a_slow_respawn(jax_launch)
    left = proc.poll() is None
    proc.kill()
    proc.wait()
    assert alive and left
    alive, proc = _teardown_during_a_slow_respawn(port_launch)
    assert not alive and proc.wait(10) is not None
