"""MPI cluster launch backend.

Reference parity: ``tracker/dmlc_tracker/mpi.py`` — build an ``mpirun``
command line that starts N workers with the ``DMLC_*`` env ABI exported
(SURVEY.md §2c).  As in the reference, MPI is ONLY a process launcher:
the transport is never MPI collectives — there it was rabit sockets, here
it is ``torch.distributed`` (NCCL or gloo) once workers call
``collectives.init()``.

Env forwarding syntax differs by MPI flavor: OpenMPI wants repeated
``-x KEY`` (value from the launching environment), MPICH/Intel want
``-env KEY VALUE``.  We detect the flavor from ``mpirun --version``.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["build_command", "launch"]


def _mpi_flavor(mpirun: str) -> str:
    try:
        out = subprocess.run([mpirun, "--version"], capture_output=True,
                             text=True, timeout=10).stdout.lower()
    except (OSError, subprocess.TimeoutExpired):
        return "openmpi"
    if "open mpi" in out or "open-rte" in out:
        return "openmpi"
    return "mpich"


def build_command(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    host_file: Optional[str] = None,
    mpirun: str = "mpirun",
    flavor: Optional[str] = None,
) -> List[str]:
    """Construct the full mpirun command line (pure; used by tests)."""
    CHECK(len(command) > 0, "mpi.build_command: empty worker command")
    flavor = flavor or _mpi_flavor(mpirun)
    cmd = [mpirun, "-n", str(nworker)]
    if host_file:
        cmd += ["--hostfile" if flavor == "openmpi" else "-f", host_file]
    env = dict(envs)
    env.setdefault("DMLC_ROLE", "worker")
    for k, v in sorted(env.items()):
        if flavor == "openmpi":
            cmd += ["-x", k]          # value comes from launching env
        else:
            cmd += ["-env", k, v]
    return cmd + list(command)


def launch(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    host_file: Optional[str] = None,
    mpirun: str = "mpirun",
) -> List[int]:
    """Run the job under mpirun; one exit code for the whole gang.

    MPI ranks do not map to ``DMLC_TASK_ID`` here — workers derive their
    id from ``OMPI_COMM_WORLD_RANK``/``PMI_RANK`` via
    ``launcher.task_id_from_env()``.
    """
    flavor = _mpi_flavor(mpirun)
    cmd = build_command(nworker, command, envs, host_file, mpirun, flavor)
    env = dict(os.environ)
    env.update(envs)
    env.setdefault("DMLC_ROLE", "worker")
    LOG("INFO", "mpi launch: %s", " ".join(cmd))
    return [subprocess.call(cmd, env=env)]
