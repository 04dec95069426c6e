"""Sun Grid Engine launch backend.

Reference parity: ``tracker/dmlc_tracker/sge.py`` — generate a ``qsub``
array-job script whose tasks run workers with the ``DMLC_*`` env ABI
(SURVEY.md §2c).  Task ids come from ``SGE_TASK_ID`` (1-based; mapped to
0-based ``DMLC_TASK_ID`` in the generated script).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import tempfile
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["build_script", "launch"]


def build_script(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    queue: Optional[str] = None,
    jobname: str = "dmlc-job",
    worker_cores: Optional[int] = None,
) -> str:
    """Generate the qsub array-job script text (pure; used by tests)."""
    CHECK(len(command) > 0, "sge.build_script: empty worker command")
    lines = [
        "#!/bin/bash",
        f"#$ -N {jobname}",
        f"#$ -t 1-{nworker}",
        "#$ -cwd",
        "#$ -V",
        "#$ -S /bin/bash",
    ]
    if queue:
        lines.append(f"#$ -q {queue}")
    if worker_cores:
        lines.append(f"#$ -pe smp {worker_cores}")
    env = dict(envs)
    env.setdefault("DMLC_ROLE", "worker")
    for k, v in sorted(env.items()):
        lines.append(f"export {k}={shlex.quote(v)}")
    lines.append('export DMLC_TASK_ID=$((SGE_TASK_ID - 1))')
    lines.append(" ".join(shlex.quote(c) for c in command))
    return "\n".join(lines) + "\n"


def launch(nworker: int, command: List[str], envs: Dict[str, str],
           qsub: str = "qsub", **kw) -> List[int]:
    """Submit ``nworker`` array-job tasks to Sun Grid Engine with the DMLC
    env ABI exported (reference dmlc_tracker/sge.py role)."""
    script = build_script(nworker, command, envs, **kw)
    fd, path = tempfile.mkstemp(prefix="dmlc_sge_", suffix=".sh")
    with os.fdopen(fd, "w") as f:
        f.write(script)
    LOG("INFO", "sge launch: qsub %s (%d tasks)", path, nworker)
    # -sync y blocks until the array job finishes so we can report a code
    return [subprocess.call([qsub, "-sync", "y", path])]
