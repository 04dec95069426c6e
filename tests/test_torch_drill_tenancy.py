"""``python -m dmlc_core_tpu_torch.tools.check_tenancy --device cpu``: the
poisoned publish (rolled back, isolated to its tenant), the hot bronze
surge (bronze sheds, gold never) and the paging churn (bit-identical
restores that build no kernel), every verdict and the JSON report of
``scripts/check_tenancy.py``, and the scorecard ``tools/slo/
tenancy.json`` (the JAX package's, unchanged) green."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_drills import checks, run_drill  # noqa: E402


def test_tenancy_scorecard_is_the_jax_packages():
    with open(os.path.join(ROOT, "scripts", "slo", "tenancy.json")) as f:
        ref = f.read()
    with open(os.path.join(ROOT, "dmlc_core_tpu_torch", "tools", "slo",
                           "tenancy.json")) as f:
        assert f.read() == ref


def test_tenancy_drill_is_green_on_the_cpu(tmp_path):
    res = run_drill("tenancy", tmp_path, outs=(
        "TENANCY_OUT", "TENANCY_METRICS_OUT", "TENANCY_TRACE_OUT",
        "TENANCY_RACECHECK_OUT", "TENANCY_LEAKCHECK_OUT", "TENANCY_SLO_OUT"))
    assert res.returncode == 0, (checks(res)[-4:], res.stderr[-3000:])
    assert res.stdout.splitlines()[-1] == "TENANCY DRILL GREEN"
    got = checks(res)
    assert all(ln.startswith("ok:") for ln in got), got
    assert any("page-ins built and loaded no kernel" in ln for ln in got)
    report = json.loads((tmp_path / "tenancy_out.json").read_text())
    poison = report["phases"]["poison"]
    assert poison["rollout"]["outcome"] == "rolled_back"
    assert poison["load"]["dropped"] == 0 and poison["load"]["wrong"] == 0
    surge = report["phases"]["surge"]["load"]
    assert surge["dropped"] == 0 and surge["wrong"] == 0
    assert surge["by_tenant"]["t4"]["shed"] >= 1
    assert surge["by_tenant"]["t0"]["shed"] == 0
    assert set(report["devices"].values()) == {"cpu"}
    assert report["observability"]["evictions_total"] >= 1
    slo = json.loads((tmp_path / "tenancy_slo_out.json").read_text())
    assert slo["pass"] and len(slo["objectives"]) == 20
