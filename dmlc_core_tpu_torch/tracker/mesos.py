"""Mesos launch backend.

Reference parity: ``tracker/dmlc_tracker/mesos.py`` (SURVEY.md §2c) —
submit N worker tasks with the ``DMLC_*`` env ABI via ``mesos-execute``
against the cluster master.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["build_command", "launch"]


def build_command(
    task_id: int,
    command: List[str],
    envs: Dict[str, str],
    master: str,
    jobname: str = "dmlc-job",
    worker_cores: int = 1,
    worker_memory_mb: int = 1024,
    mesos_execute: str = "mesos-execute",
) -> List[str]:
    """Construct one worker's mesos-execute command (pure; for tests)."""
    CHECK(len(command) > 0, "mesos.build_command: empty worker command")
    env = dict(envs)
    env["DMLC_TASK_ID"] = str(task_id)
    env.setdefault("DMLC_ROLE", "worker")
    env_json = json.dumps(
        {"variables": [{"name": k, "value": str(v)} for k, v in sorted(env.items())]})
    return [
        mesos_execute,
        f"--master={master}",
        f"--name={jobname}-{task_id}",
        f"--command={' '.join(command)}",
        f"--env={env_json}",
        f"--resources=cpus:{worker_cores};mem:{worker_memory_mb}",
    ]


def launch(nworker: int, command: List[str], envs: Dict[str, str],
           master: Optional[str] = None, **kw) -> List[int]:
    """Launch workers through Mesos: builds per-task command/resource specs
    (reference dmlc_tracker/mesos.py role) and submits them."""
    master = master or os.environ.get("MESOS_MASTER", "127.0.0.1:5050")
    procs = []
    for task_id in range(nworker):
        cmd = build_command(task_id, command, envs, master, **kw)
        LOG("INFO", "mesos worker %d → %s", task_id, master)
        procs.append(subprocess.Popen(cmd))
    return [p.wait() for p in procs]
