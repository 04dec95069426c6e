"""dmlc-submit option surface → JobSet configurations.

``tracker/submit.py`` used to dispatch each cluster backend to its own
one-shot ``launch()`` function; with the launch subsystem the local,
ssh and kubernetes backends are *configurations of the same supervised
JobSet* — only the transport differs.  :func:`jobset_from_opts` is that
mapping, kept pure enough for the golden per-backend env/manifest tests
to call it straight from parsed CLI options.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.launch.jobset import JobSet
from dmlc_core_tpu_torch.launch.k8s import K8sTransport
from dmlc_core_tpu_torch.launch.transport import (LocalTransport, SSHTransport,
                                            Transport)

__all__ = ["jobset_from_opts", "transport_from_opts"]

#: clusters the JobSet supervisor backs; the rest keep their dedicated
#: scheduler-submission backends (mpi/sge/slurm/yarn/mesos hand the
#: supervision problem to the cluster manager itself)
SUPERVISED_CLUSTERS = ("local", "ssh", "kubernetes")


def transport_from_opts(opts: argparse.Namespace) -> Transport:
    """The Transport a dmlc-submit option namespace selects."""
    if opts.cluster == "local":
        return LocalTransport()
    if opts.cluster == "ssh":
        from dmlc_core_tpu_torch.tracker.ssh import read_host_file

        CHECK(opts.host_file is not None, "--cluster ssh needs --host-file")
        return SSHTransport(read_host_file(opts.host_file))
    if opts.cluster == "kubernetes":
        CHECK(opts.image is not None, "--cluster kubernetes needs --image")
        return K8sTransport(
            opts.image, jobname=opts.jobname,
            dry_run=bool(getattr(opts, "dry_run", False)),
            worker_cores=opts.worker_cores,
            worker_memory_mb=opts.worker_memory,
            slots=opts.num_workers)
    raise ValueError(
        f"cluster {opts.cluster!r} is not JobSet-supervised "
        f"(supported: {', '.join(SUPERVISED_CLUSTERS)})")


def jobset_from_opts(opts: argparse.Namespace, command: List[str],
                     envs: Dict[str, str],
                     extra_env: Optional[Dict[str, str]] = None) -> JobSet:
    """Build the supervised JobSet for a dmlc-submit invocation.

    ``envs`` is the tracker env ABI (``slave_envs()``), ``extra_env``
    the user's ``--env KEY=VALUE`` overlay.  ``--max-attempts`` is the
    restart budget (attempt 0 is the launch itself, so the JobSet gets
    ``max_attempts - 1`` respawns).
    """
    merged = dict(envs)
    merged.update(extra_env or {})
    restart_limit = max(0, int(getattr(opts, "max_attempts", 1)) - 1)
    return JobSet(command, opts.num_workers,
                  transport=transport_from_opts(opts),
                  envs=merged, name=opts.jobname,
                  restart_limit=restart_limit)
