"""Local multi-process launch backend.

Reference parity: ``tracker/dmlc_tracker/local.py`` — fork N worker
subprocesses on one machine with the env ABI injected.  This is how the
reference "tests multi-node without a cluster" (SURVEY.md §4), and how
the port exercises ``torch.distributed`` groups (gloo on the CPU, ranks
sharing one card, or NCCL) on one machine.

Since the launch subsystem landed this is a thin shim over a supervised
:class:`~dmlc_core_tpu_torch.launch.JobSet` on a
:class:`~dmlc_core_tpu_torch.launch.LocalTransport` — same signature and
return value, but children carry ``PR_SET_PDEATHSIG`` (no orphan leak on
parent death) and every handle is owned until teardown instead of
fire-and-forget.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["launch"]


def launch(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    extra_env: Optional[Dict[str, str]] = None,
    timeout: Optional[float] = None,
) -> List[int]:
    """Run ``command`` in ``nworker`` local processes; returns exit codes.

    Each worker gets the shared env ABI plus ``DMLC_TASK_ID``/
    ``DMLC_ROLE=worker``.  Workers calling ``collectives.init()`` will form
    a ``torch.distributed`` group with rank 0 hosting the TCP store at
    ``DMLC_TRACKER_URI:DMLC_TRACKER_PORT``.
    """
    from dmlc_core_tpu_torch.launch import JobSet, LaunchTimeout, LocalTransport

    CHECK(len(command) > 0, "local.launch: empty worker command")
    merged = dict(envs)
    if extra_env:
        merged.update(extra_env)
    js = JobSet(command, nworker, transport=LocalTransport(),
                envs=merged, name="local", restart_limit=0)
    try:
        codes = js.run(timeout=timeout)
    except LaunchTimeout:
        # historical contract: callers catch subprocess.TimeoutExpired
        raise subprocess.TimeoutExpired(command, timeout)  # noqa: B904
    failed = [i for i, c in enumerate(codes) if c != 0]
    if failed:
        LOG("ERROR", "local launch: workers %s exited nonzero (%s)", failed,
            [codes[i] for i in failed])
    return codes
