"""Launch-option surface for dmlc-submit.

Reference parity: ``tracker/dmlc_tracker/opts.py :: get_opts`` — cluster
selection, worker counts, resources, env passthrough (SURVEY.md §2c).
All reference clusters are supported: ``local`` (single machine, the test
path), ``ssh``, ``mpi``, ``sge``, ``slurm``, ``yarn``, ``mesos``,
``kubernetes``.  Either way the ``DMLC_*`` env ABI is what workers
consume (``collectives.init()`` → ``torch.distributed``).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

__all__ = ["CLUSTERS", "get_opts"]

CLUSTERS = ["local", "ssh", "mpi", "sge", "slurm", "yarn", "mesos", "kubernetes"]


def get_opts(args: Optional[List[str]] = None) -> Tuple[argparse.Namespace, List[str]]:
    """Parse dmlc-submit command-line options; returns (namespace,
    leftover worker command) with the same flag surface as the
    reference dmlc_tracker/opts.py."""
    parser = argparse.ArgumentParser(
        prog="dmlc-submit",
        description="Submit a distributed dmlc_core_tpu_torch job",
    )
    parser.add_argument("--cluster", choices=CLUSTERS, default="local",
                        help="launch backend")
    parser.add_argument("-n", "--num-workers", type=int, required=True,
                        help="number of worker processes")
    parser.add_argument("-s", "--num-servers", type=int, default=0,
                        help="number of server processes (PS mode)")
    parser.add_argument("-H", "--host-file", type=str, default=None,
                        help="file listing one host per line (ssh/mpi clusters)")
    parser.add_argument("--host-ip", type=str, default="127.0.0.1",
                        help="tracker/coordinator bind address")
    parser.add_argument("--jobname", type=str, default="dmlc-job")
    parser.add_argument("--queue", type=str, default=None,
                        help="scheduler queue/partition (sge/slurm/yarn)")
    parser.add_argument("--worker-cores", type=int, default=None,
                        help="cores per worker (resource-managed clusters)")
    parser.add_argument("--worker-memory", type=int, default=None,
                        help="MB of memory per worker (resource-managed clusters)")
    parser.add_argument("--image", type=str, default=None,
                        help="container image (kubernetes cluster)")
    parser.add_argument("--mesos-master", type=str, default=None,
                        help="mesos master host:port")
    parser.add_argument("--max-attempts", type=int, default=3,
                        help="max launch attempts per worker (JobSet restart "
                             "budget is max-attempts - 1)")
    parser.add_argument("--dry-run", action="store_true",
                        help="kubernetes: render Job manifests without "
                             "invoking kubectl")
    parser.add_argument("--env", action="append", default=[],
                        help="extra KEY=VALUE env for workers (repeatable)")
    parser.add_argument("--log-level", choices=["DEBUG", "INFO", "WARNING", "ERROR"],
                        default="INFO")
    parser.add_argument("--start-legacy-tracker", action="store_true",
                        help="also run the RabitTracker TCP service for "
                             "legacy (rabit-protocol) workers")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="worker command (after --)")
    opts = parser.parse_args(args)
    command = opts.command
    if command and command[0] == "--":
        command = command[1:]
    return opts, command
