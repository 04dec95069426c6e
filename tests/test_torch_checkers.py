"""The port's SLO scorecard and dynamic checkers (``base/slo.py``,
``base/lockcheck.py``, ``base/racecheck.py``, ``base/leakcheck.py``) on
the CPU.

The JAX package's own suites are loaded against the port's copies
(``*_port``): ``tests/test_slo.py``, ``tests/test_leakcheck.py``,
``tests/test_racecheck.py`` (over the port's instrumented
``ConcurrentBlockingQueue``) and the lockcheck tests of
``tests/test_dmlcheck.py`` (its dmlcheck tests analyse the JAX tree and
are left out, with the ``analysis`` import they need).

The port's own checks: the scorecard ``--prodsim`` gates on is the JAX
package's, objective for objective; the checkers install at import
under their ``DMLC_*`` switches; the classes JAX instruments are
instrumented here (a seeded unlocked pair on each is a race, their
exempt attributes are not).
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu_torch.base import racecheck, slo  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402

_SLO = load_port("test_slo.py")
export(globals(), _SLO, ["TestSpecValidation", "TestResolution",
                         "TestFailureSemantics", "TestCommittedSpecs"])
_LEAK = load_port("test_leakcheck.py")
export(globals(), _LEAK, funcs=[n for n in dir(_LEAK)
                                if n.startswith("test_")])
traced = _LEAK.traced
_RACE = load_port("test_racecheck.py")
export(globals(), _RACE, funcs=[n for n in dir(_RACE)
                                if n.startswith("test_")])
rc = _RACE.rc
# its ``traced`` fixture is lockcheck's; test_leakcheck's has the name too
_LOCK = load_port("test_dmlcheck.py", [
    ("from dmlc_core_tpu.analysis import analyze, load_baseline, "
     "write_baseline\n", ""),
    ("def traced():", "def lock_traced():"),
    ("(traced):", "(lock_traced):")])
export(globals(), _LOCK, funcs=[n for n in dir(_LOCK)
                                if n.startswith("test_lockcheck_")])
lock_traced = _LOCK.lock_traced


def test_prodsim_scorecard_is_the_jax_packages():
    with open(os.path.join(ROOT, "scripts", "slo", "prodsim.json")) as f:
        want = json.load(f)
    path = os.path.join(ROOT, "dmlc_core_tpu_torch", "tools", "slo",
                        "prodsim.json")
    with open(path) as f:
        got = json.load(f)
    assert got == want
    spec = slo.SLOSpec.load(path)
    assert [o["name"] for o in spec.objectives] == \
        [o["name"] for o in want["objectives"]]


@pytest.mark.parametrize("var,module", [
    ("DMLC_LOCKCHECK", "lockcheck"), ("DMLC_RACECHECK", "racecheck"),
    ("DMLC_LEAKCHECK", "leakcheck")])
def test_checkers_install_at_import(var, module):
    code = ("import dmlc_core_tpu_torch\n"
            f"from dmlc_core_tpu_torch.base import {module} as m, knobs\n"
            f"print('INSTALLED', m.installed(), knobs.value({var!r}))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMLC_LOCKCHECK", "DMLC_RACECHECK",
                        "DMLC_LEAKCHECK")}
    for val, want in (("1", "True 1"), ("0", "False 0")):
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             env={**env, var: val}, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert f"INSTALLED {want}" in res.stdout, res.stdout


def _race_on(obj, attr):
    """A seeded unlocked write / read pair on ``obj.attr`` from two
    threads (a sleep is no happens-before edge); the races it leaves."""
    racecheck.reset()
    value = object.__getattribute__(obj, attr)

    def writer():
        setattr(obj, attr, value)

    def reader():
        time.sleep(0.05)
        getattr(obj, attr)

    threads = [threading.Thread(target=fn) for fn in (writer, reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return [r for r in racecheck.races() if r["attr"] == attr]


def test_instrumented_classes_report_races(rc):
    from dmlc_core_tpu_torch.io.concurrency import ConcurrentBlockingQueue
    from dmlc_core_tpu_torch.serve.batcher import DynamicBatcher
    from dmlc_core_tpu_torch.serve.registry import ModelRegistry
    from dmlc_core_tpu_torch.serve.tenancy.registry import TenantRegistry

    reg = ModelRegistry("rc", device="cpu")
    ten = TenantRegistry(resident_cap=2, device="cpu")
    q = ConcurrentBlockingQueue(max_size=2)
    b = DynamicBatcher(lambda X: X, max_batch=4)
    try:
        for obj, attr in ((reg, "_runner_opts"), (ten, "_runner_opts"),
                          (q, "_max"), (b, "_execute")):
            assert type(obj) in racecheck._TARGETS, type(obj)
            assert _race_on(obj, attr), (type(obj).__name__, attr)
        assert ModelRegistry._racecheck_exempt == frozenset({"_current"})
        assert TenantRegistry._racecheck_exempt == frozenset({"_tenants"})
        assert not _race_on(reg, "_current")
        assert not _race_on(ten, "_tenants")
    finally:
        b.close()
        racecheck.reset()
