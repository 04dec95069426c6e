"""Runs a chaos drill of the port (``python -m
dmlc_core_tpu_torch.tools.check_<name> --device cpu``) in a subprocess
for the ``tests/test_torch_drill_*.py`` files: its artifacts under the
test's directory, the checkers on, its own time limit."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_drill(name, tmp_path, outs=(), timeout=240, device="cpu", **extra):
    """Run drill ``name``; ``outs`` are its artifact variables, each set
    to ``tmp_path / <var>.json``; ``extra`` more of its environment.
    Returns the finished process."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "BENCH_", "FLEET_", "DRILL_"))}
    env.update(PYTHONPATH=ROOT, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1",
               DMLC_METRICS_SPOOL=str(tmp_path / "spool"))
    env.update({var: str(tmp_path / f"{var.lower()}.json") for var in outs})
    env.update(extra)
    cmd = [sys.executable, "-m", f"dmlc_core_tpu_torch.tools.check_{name}"]
    if device is not None:
        cmd += ["--device", device]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def checks(res):
    """The drill's verdict lines (``ok: ...`` and ``FAIL: ...``)."""
    return [ln for ln in res.stdout.splitlines()
            if ln.startswith(("ok:", "FAIL:"))]
