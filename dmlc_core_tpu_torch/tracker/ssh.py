"""SSH cluster launch backend.

Reference parity: ``tracker/dmlc_tracker/ssh.py`` — read a host file, start
one worker per slot via ``ssh host 'env ... cmd'`` (SURVEY.md §2c).

Since the launch subsystem landed this is a thin shim over a supervised
:class:`~dmlc_core_tpu_torch.launch.JobSet` on an
:class:`~dmlc_core_tpu_torch.launch.SSHTransport` — same signature and return
value, but the ssh client processes are owned handles (polled, signalled
and reaped at teardown) instead of fire-and-forget Popens.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["launch", "read_host_file"]


def read_host_file(path: str) -> List[str]:
    """Read an MPI-style host file (one ``host[:slots]`` per line, ``#``
    comments) into a host slot list: a host with ``:slots`` appears that
    many times, so round-robin placement fills its slots."""
    hosts: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            token = line.split()[0]
            host, sep, slots = token.rpartition(":")
            if sep and slots.isdigit():
                CHECK(int(slots) > 0,
                      f"host file {path!r}: bad slot count in {token!r}")
                hosts.extend([host] * int(slots))
            else:
                hosts.append(token)
    CHECK(len(hosts) > 0, f"host file {path!r} has no hosts")
    return hosts


def launch(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    hosts: List[str],
    cwd: Optional[str] = None,
    ssh_binary: str = "ssh",
) -> List[int]:
    """Start workers round-robin over ``hosts``; wait for completion."""
    from dmlc_core_tpu_torch.launch import JobSet, SSHTransport

    CHECK(len(command) > 0, "ssh.launch: empty worker command")
    transport = SSHTransport(hosts, cwd=cwd or os.getcwd(),
                             ssh_binary=ssh_binary)
    js = JobSet(command, nworker, transport=transport, envs=envs,
                name="ssh", restart_limit=0)
    return js.run()
