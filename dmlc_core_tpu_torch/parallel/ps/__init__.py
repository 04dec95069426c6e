"""Sharded parameter server behind the KVStore surface.

The ps-lite role dmlc-core's ``PSTracker`` only ever exported as an env
ABI, built for real: key-range-partitioned server shards with
server-side aggregation (Li et al., OSDI'14) and bounded-staleness
async push/pull (SSP, Ho et al. NIPS'13).

Layout::

    partition.py  key-range cut, routing, rebalance plans
    wire.py       JSON-header + raw-array-frame socket framing
    server.py     PSScheduler (discovery) + PSServer (range shard)
    client.py     PSClient: pipelined async push/pull, SSP window

Process roles bind through the same ``DMLC_ROLE`` + ``DMLC_PS_ROOT_*``
env ABI the tracker launchers already export: a launched process calls
:func:`run_role` (or ``KVStore.create("dist_async")``, which defers to
it for non-worker roles) and becomes the scheduler, a server shard, or
returns a worker-side client.

The PyTorch port's counterpart of ``dmlc_core_tpu/parallel/ps``: host
numpy and sockets, as in the JAX package.  The wire format, the
scheduler protocol and the server snapshots (a pickled leaf through
``parallel.checkpoint``) are byte for byte the JAX package's, so a
client of either package works against servers of the other, and a
snapshot written by either restores in the other.
"""

from __future__ import annotations

import sys
from typing import Optional

from dmlc_core_tpu_torch.parallel.ps.client import PSClient
from dmlc_core_tpu_torch.parallel.ps.partition import (rebalance_plan,
                                                 route_hashed,
                                                 server_of,
                                                 server_ranges,
                                                 split_by_server)
from dmlc_core_tpu_torch.parallel.ps.server import (PSScheduler, PSServer,
                                              ps_metrics)

__all__ = ["PSClient", "PSScheduler", "PSServer", "ps_metrics",
           "server_ranges", "server_of", "split_by_server",
           "rebalance_plan", "route_hashed", "run_role"]


def run_role(role: Optional[str] = None) -> Optional[PSClient]:
    """Bind this process to its PS role from the env ABI.

    ``worker`` returns a connected :class:`PSClient`; ``scheduler``
    and ``server`` run their service loop to job completion and then
    ``sys.exit(0)`` — the launched-subprocess contract, mirroring
    dmlc-core's ps-lite launchers where non-worker roles never return
    to user code.
    """
    from dmlc_core_tpu_torch.base import knobs as _knobs
    from dmlc_core_tpu_torch.base.logging import Error

    if role is None:
        role = str(_knobs.value("DMLC_ROLE"))
    uri = str(_knobs.value("DMLC_PS_ROOT_URI")) or "127.0.0.1"
    port = int(_knobs.value("DMLC_PS_ROOT_PORT") or 0)
    if role == "worker":
        return PSClient(root_uri=uri, root_port=port)
    if role == "scheduler":
        sched = PSScheduler(
            host_ip=uri, port=port,
            nworker=int(_knobs.value("DMLC_NUM_WORKER")),
            nserver=int(_knobs.value("DMLC_NUM_SERVER") or 1))
        sched.start()
        sched.join()
        sys.exit(0)
    if role == "server":
        server = PSServer(
            scheduler_uri=uri, scheduler_port=port,
            host_ip=str(_knobs.value("DMLC_PS_SERVER_URI")),
            server_id=int(_knobs.value("DMLC_PS_SERVER_ID")))
        server.start()
        server.serve_forever()
        sys.exit(0)
    raise Error(f"unknown DMLC_ROLE {role!r} for parameter server")
