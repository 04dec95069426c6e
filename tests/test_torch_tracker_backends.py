"""The port's ``dmlc-submit`` launchers (``tracker/opts.py``,
``launcher.py``, ``local.py``, ``ssh.py``, ``mpi.py``, ``slurm.py``,
``sge.py``, ``yarn.py``, ``mesos.py``, ``kubernetes.py``, ``submit.py``)
on the CPU.

``tests/test_tracker_backends.py`` is loaded against the port whole
(``*_port``): every backend's command, script or manifest builder, the
launcher shim's env ABI, the host file, the option surface and the
elastic YARN restarts against a fake ResourceManager.  Its end-to-end CLI
test (marked slow in the JAX file, so outside the tier-1 run) starts the
port's CLI, ``python -m dmlc_core_tpu_torch.tracker.submit``, where the
JAX file starts the root ``dmlc-submit`` script (which is the JAX
package's), from the checkout's root so that ``-m`` finds the package.

The port's own check: the CLI's ``--help`` runs without jax.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_suites import export, load_port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BACKENDS = load_port("test_tracker_backends.py", [
    ('[sys.executable, str(REPO / "dmlc-submit"), "--cluster=local",',
     '[sys.executable, "-m", "dmlc_core_tpu.tracker.submit",\n'
     '         "--cluster=local",'),
    ("capture_output=True, text=True, timeout=120, cwd=str(tmp_path))",
     "capture_output=True, text=True, timeout=120, cwd=str(REPO))")])
export(globals(), _BACKENDS,
       [n for n in dir(_BACKENDS) if n.startswith("Test")],
       [n for n in dir(_BACKENDS) if n.startswith("test_")])
fake_rm = _BACKENDS.fake_rm


def test_submit_cli_help_loads_no_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['submit', '--help']\n"
            "try:\n"
            "    runpy.run_module('dmlc_core_tpu_torch.tracker.submit',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
            "             or m.split('.')[0] == 'dmlc_core_tpu')\n"
            "print('LOADED', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--num-workers" in res.stdout
    assert "LOADED []" in res.stdout, res.stdout
