"""Worker-side bootstrap shim.

Reference parity: ``tracker/dmlc_tracker/launcher.py`` (SURVEY.md §2c) —
runs ON the remote worker: normalizes the environment (derives
``DMLC_TASK_ID`` from the cluster manager's rank variable when the
launcher couldn't inject it), optionally changes directory, then execs the
user command.  Usage::

    python -m dmlc_core_tpu_torch.tracker.launcher -- python worker.py
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["task_id_from_env", "prepare_env", "main"]

# cluster-manager rank variables, in lookup order
_RANK_VARS = [
    "DMLC_TASK_ID",              # already injected by local/ssh/sge backends
    "OMPI_COMM_WORLD_RANK",      # OpenMPI
    "PMI_RANK",                  # MPICH / Intel MPI / Slurm PMI
    "SLURM_PROCID",              # Slurm
    "JOB_COMPLETION_INDEX",      # Kubernetes indexed Job
]


def task_id_from_env(env: Optional[Dict[str, str]] = None,
                     required: bool = False) -> int:
    """Worker index assigned by the cluster manager, read from the DMLC
    launcher env (``DMLC_TASK_ID``) or a cluster-manager rank variable
    in ``_RANK_VARS`` precedence order.  Defaults to 0 when nothing is
    set (single-process convenience); pass ``required=True`` to CHECK
    instead — the multi-host path, where a silent rank-0 default would
    collide every worker onto the same rank."""
    env = os.environ if env is None else env
    for var in _RANK_VARS:
        if var in env and str(env[var]).strip() != "":
            return int(env[var])
    CHECK(not required,
          f"no rank variable set (looked for {', '.join(_RANK_VARS)})")
    return 0


def prepare_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Return a normalized copy of ``env`` with the DMLC ABI filled in."""
    base = dict(os.environ if env is None else env)
    base["DMLC_TASK_ID"] = str(task_id_from_env(base))
    base.setdefault("DMLC_ROLE", "worker")
    base.setdefault("DMLC_NUM_ATTEMPT", "0")
    return base


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point of the per-task launcher shim: re-execs ``command`` with
    the tracker env applied (reference dmlc_tracker/launcher.py role)."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--":
        argv = argv[1:]
    CHECK(len(argv) > 0, "launcher: no command given")
    env = prepare_env()
    workdir = env.get("DMLC_WORKDIR")
    if workdir:
        os.chdir(workdir)
    os.execvpe(argv[0], argv, env)


if __name__ == "__main__":
    sys.exit(main())
