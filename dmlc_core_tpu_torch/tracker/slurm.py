"""Slurm cluster launch backend.

Reference parity: ``tracker/dmlc_tracker/slurm.py`` — launch N workers via
``srun`` with the ``DMLC_*`` env ABI exported (SURVEY.md §2c).  Workers
derive their task id from ``SLURM_PROCID`` (``launcher.task_id_from_env``).
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["build_command", "launch"]


def build_command(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    queue: Optional[str] = None,
    jobname: str = "dmlc-job",
    worker_cores: Optional[int] = None,
    worker_memory_mb: Optional[int] = None,
    srun: str = "srun",
) -> List[str]:
    """Construct the srun command line (pure; used by tests)."""
    CHECK(len(command) > 0, "slurm.build_command: empty worker command")
    cmd = [srun, f"--ntasks={nworker}", f"--job-name={jobname}", "--kill-on-bad-exit=1"]
    if queue:
        cmd.append(f"--partition={queue}")
    if worker_cores:
        cmd.append(f"--cpus-per-task={worker_cores}")
    if worker_memory_mb:
        # --mem-per-cpu multiplies by cpus-per-task; divide so the total
        # per-task allocation equals the requested MB per worker
        per_cpu = -(-worker_memory_mb // max(worker_cores or 1, 1))
        cmd.append(f"--mem-per-cpu={per_cpu}M")
    env = dict(envs)
    env.setdefault("DMLC_ROLE", "worker")
    exports = ",".join(f"{k}={v}" for k, v in sorted(env.items()))
    cmd.append(f"--export=ALL,{exports}")
    return cmd + list(command)


def launch(nworker: int, command: List[str], envs: Dict[str, str],
           **kw) -> List[int]:
    """Launch workers via ``srun`` with the DMLC env ABI exported
    (reference dmlc_tracker/slurm.py role)."""
    cmd = build_command(nworker, command, envs, **kw)
    LOG("INFO", "slurm launch: %s", " ".join(cmd))
    return [subprocess.call(cmd, env=dict(os.environ))]
