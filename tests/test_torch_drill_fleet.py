"""``python -m dmlc_core_tpu_torch.tools.check_fleet --device cpu``: the
kill, rescale and rollout phases under verified load, every verdict and
the JSON report of ``scripts/check_fleet.py``, the scorecard
``tools/slo/fleet.json`` (the JAX package's, unchanged) green, and zero
kernel builds in the parent's steady window."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_drills import checks, run_drill  # noqa: E402


def test_fleet_scorecard_is_the_jax_packages():
    with open(os.path.join(ROOT, "scripts", "slo", "fleet.json")) as f:
        ref = f.read()
    with open(os.path.join(ROOT, "dmlc_core_tpu_torch", "tools", "slo",
                           "fleet.json")) as f:
        assert f.read() == ref


def test_fleet_drill_is_green_on_the_cpu(tmp_path):
    res = run_drill("fleet", tmp_path, outs=(
        "FLEET_OUT", "FLEET_METRICS_OUT", "FLEET_TRACE_OUT",
        "FLEET_RACECHECK_OUT", "FLEET_LEAKCHECK_OUT", "FLEET_JITCHECK_OUT",
        "FLEET_SLO_OUT"))
    assert res.returncode == 0, (checks(res)[-4:], res.stderr[-3000:])
    assert res.stdout.splitlines()[-1] == "FLEET CHAOS DRILL GREEN"
    got = checks(res)
    assert all(ln.startswith("ok:") for ln in got), got
    report = json.loads((tmp_path / "fleet_out.json").read_text())
    assert sorted(report["phases"]) == ["kill", "rescale", "rollout"]
    for phase in ("kill", "rollout"):
        load = report["phases"][phase]["load"]
        assert load["dropped"] == 0 and load["wrong"] == 0 and load["ok"] > 0
    assert report["phases"]["rollout"]["rollout"]["outcome"] == "activated"
    assert set(report["phases"]["rollout"]["final_versions"].values()) == {2}
    assert set(report["devices"].values()) == {"cpu"}
    assert report["observability"]["cross_process_traces"] >= 1
    slo = json.loads((tmp_path / "fleet_slo_out.json").read_text())
    assert slo["pass"] and len(slo["objectives"]) == 8
    jit = json.loads((tmp_path / "fleet_jitcheck_out.json").read_text())
    assert jit["compiles_steady"] == 0
