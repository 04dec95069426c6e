"""``python -m dmlc_core_tpu_torch.tools.check_ps --device cpu``: the
baseline and the kill-and-restore of a PS server (the replacement
restores its snapshot as the same id, every worker reconverges), every
verdict and the JSON report of ``scripts/check_ps.py``, and the
scorecard ``tools/slo/ps.json`` (the JAX package's, unchanged) green;
at one pass over each worker's shard (the drill's ``PS_DRILL_EPOCHS``).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_drills import checks, run_drill  # noqa: E402


def test_ps_scorecard_is_the_jax_packages():
    with open(os.path.join(ROOT, "scripts", "slo", "ps.json")) as f:
        ref = f.read()
    with open(os.path.join(ROOT, "dmlc_core_tpu_torch", "tools", "slo",
                           "ps.json")) as f:
        assert f.read() == ref


def test_ps_drill_is_green_on_the_cpu(tmp_path):
    # one pass over each worker's shard, where the JAX drill makes three
    res = run_drill("ps", tmp_path, outs=(
        "PS_DRILL_OUT", "PS_METRICS_OUT", "PS_TRACE_OUT", "PS_RACECHECK_OUT",
        "PS_LEAKCHECK_OUT", "PS_SLO_OUT"), PS_DRILL_EPOCHS="1")
    assert res.returncode == 0, (checks(res)[-4:], res.stderr[-3000:])
    assert res.stdout.splitlines()[-1] == "PS CHAOS DRILL GREEN"
    got = checks(res)
    assert all(ln.startswith("ok:") for ln in got), got
    assert any("kill: server 1 SIGKILLed mid-epoch (rc=-9)" in ln
               for ln in got)
    report = json.loads((tmp_path / "ps_drill_out.json").read_text())
    assert report["respawn"]["server_id"] == 1
    assert report["respawn"]["restored_version"] >= 1
    assert report["devices"] == ["cpu"]
    for phase in ("baseline", "kill"):
        assert len(report[phase]) == 3
        assert all(w["accuracy"] >= 0.74 for w in report[phase].values())
    assert report["slo"]["pass"] and len(report["slo"]["objectives"]) == 7
