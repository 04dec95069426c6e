"""``python -m dmlc_core_tpu_torch.tools.check_resilience`` on the CPU:
the checkpoint kill-and-recover drill and the lossy-wire S3 round trip
(host-only, as the JAX drill) under the lock-order, race and leak
checkers, every verdict of ``scripts/check_resilience.py`` green."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_drills import checks, run_drill  # noqa: E402

VERDICTS = (
    "clean v1 save", "v1 loads back bit-identical",
    "v2 writer was SIGKILLed mid-write (rc=-9)",
    "post-kill load still serves v1 bit-identical", "clean v2 save",
    "v2 visible after clean save", "corrupt v2 falls back to retained v1",
    "multipart write + ranged read byte-identical under faults",
    "faults actually fired", "retries recorded on the registry",
    "metrics spool merged", "zero lock-order cycles",
    "zero happens-before races", "zero live resource leaks")


def test_resilience_drill_is_green_on_the_cpu(tmp_path):
    res = run_drill("resilience", tmp_path, device=None, outs=(
        "RESILIENCE_METRICS_OUT", "RESILIENCE_RACECHECK_OUT",
        "RESILIENCE_LEAKCHECK_OUT"))
    assert res.returncode == 0, (checks(res)[-4:], res.stderr[-3000:])
    assert res.stdout.splitlines()[-1] == "RESILIENCE SMOKE GREEN"
    got = checks(res)
    assert all(ln.startswith("ok:") for ln in got), got
    for verdict in VERDICTS:
        assert any(verdict in ln for ln in got), (verdict, got)
    race = json.loads((tmp_path / "resilience_racecheck_out.json")
                      .read_text())
    leak = json.loads((tmp_path / "resilience_leakcheck_out.json")
                      .read_text())
    assert race["races"] == [] and leak["leaks"] == []
