"""What the chaos drills (``tools/check_*.py``) share: the verdict line,
artifact paths, and the checkers' install and gate (their traces are
merged by ``tools/trace_collect.py``)."""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Dict, Tuple

CHECKERS = ("DMLC_LOCKCHECK", "DMLC_RACECHECK", "DMLC_LEAKCHECK")


def check(cond: Any, msg: str) -> None:
    """``ok: msg``, or ``FAIL: msg`` and exit 1."""
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)
    print(f"ok: {msg}", flush=True)


def out(var: str, name: str) -> str:
    """An artifact's path: ``$var``, else ``name`` in the temporary
    directory."""
    return os.environ.get(var) or os.path.join(tempfile.gettempdir(), name)


def install_checkers(trace: bool = False) -> None:
    """Turn the lock-order, race and leak checkers on (and ``DMLC_TRACE``
    with ``trace``) unless the caller's env says otherwise, and install
    them.  The package's import installs what its env names; under ``-m``
    that ran before these defaults were set, so this installs them here,
    in its order (leakcheck's ``Thread.start`` hook chains racecheck's).
    Children inherit the env and install them at import."""
    from dmlc_core_tpu_torch.base import leakcheck, lockcheck, racecheck
    from dmlc_core_tpu_torch.utils import profiler

    for var in CHECKERS + (("DMLC_TRACE",) if trace else ()):
        os.environ.setdefault(var, "1")
    for checker in (lockcheck, racecheck, leakcheck):
        if checker.env_enabled() and not checker.installed():
            checker.install()
    if trace:
        profiler.set_tracing(os.environ["DMLC_TRACE"].lower()
                             in ("1", "true", "on", "yes"))


def gate_checkers(prefix: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The parent's checker gate: zero lock-order cycles, zero races
    (report at ``$<prefix>_RACECHECK_OUT``) and zero live leaks (report at
    ``$<prefix>_LEAKCHECK_OUT``); returns both reports."""
    from dmlc_core_tpu_torch.base import leakcheck, lockcheck, racecheck

    tag = prefix.lower()
    lockcheck.check()
    print("ok: zero lock-order cycles under DMLC_LOCKCHECK=1 (parent)")
    rc_out = out(f"{prefix}_RACECHECK_OUT", f"{tag}_racecheck.json")
    rc_report = racecheck.write_report(rc_out)
    racecheck.check()
    print(f"ok: zero happens-before races under DMLC_RACECHECK=1 "
          f"(parent; report at {rc_out})")
    lk_out = out(f"{prefix}_LEAKCHECK_OUT", f"{tag}_leakcheck.json")
    lk_report = leakcheck.write_report(lk_out)
    leakcheck.check()
    print(f"ok: zero live resource leaks under DMLC_LEAKCHECK=1 "
          f"(parent; report at {lk_out})", flush=True)
    return rc_report, lk_report


def child_env(device: str, **extra: str) -> Dict[str, str]:
    """The env a drill's child starts with: the caller's, the checkers
    on, no fault inherited, its device (``DRILL_DEVICE``; replicas read
    ``FLEET_DEVICE``) and ``extra``."""
    env = dict(os.environ)
    env.update({var: "1" for var in CHECKERS[:2]})
    env.update(DMLC_FAULT_INJECT="", DRILL_DEVICE=device,
               FLEET_DEVICE=device)
    env.update(extra)
    return env


def child_device() -> str:
    """A drill child's device: ``DRILL_DEVICE`` (unset: ``cuda``), which
    must be reachable — a child never carries on on the CPU when the
    parent asked for the card."""
    from dmlc_core_tpu_torch.utils.device import resolve_device

    return str(resolve_device(os.environ.get("DRILL_DEVICE") or None))


def slo_gate(spec_name: str, prefix: str, merged: Dict[str, Any],
             evidence: Dict[str, Any], here: str) -> Dict[str, Any]:
    """Evaluate ``tools/slo/<spec_name>.json`` (or ``$<prefix>_SLO_SPEC``)
    on the merged metrics and the evidence, print every objective, write
    the scorecard to ``$<prefix>_SLO_OUT`` and require it green."""
    from dmlc_core_tpu_torch.base import slo

    spec_path = os.environ.get(f"{prefix}_SLO_SPEC") or os.path.join(
        here, "slo", f"{spec_name}.json")
    scorecard = slo.evaluate(slo.SLOSpec.load(spec_path), merged, evidence)
    slo_out = out(f"{prefix}_SLO_OUT", f"{prefix.lower()}_slo.json")
    with open(slo_out, "w") as f:
        json.dump(scorecard, f, indent=2)
    for row in scorecard["objectives"]:
        print(f"   slo[{row['name']}]: "
              f"{'pass' if row['pass'] else 'FAIL'} "
              f"(observed {row['observed']} {row['op']} "
              f"{row['threshold']}; {row['evidence']})")
    check(scorecard["pass"],
          f"SLO scorecard {scorecard['spec']} green "
          f"(spec {spec_path}, scorecard at {slo_out})")
    return scorecard


