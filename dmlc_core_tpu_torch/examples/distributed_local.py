"""Distributed data parallelism over the ``DMLC_*`` launch ABI.

    python -m dmlc_core_tpu_torch.examples.distributed_local [--device cpu]

The port of ``examples/distributed_local.py``.  Run as above, it launches
4 workers of itself on this machine through dmlc-submit's local cluster
(``python -m dmlc_core_tpu_torch.tracker.submit --cluster local -n 4``);
each worker (``--worker``) joins the process group the env ABI describes
(``collectives.init``; gloo, since the workers share one card and NCCL
refuses two ranks on one device), draws its own 20,000 × 10 shard, takes
its shard's histogram of feature 0 on its device, and allreduces it: the
global histogram holds every worker's rows.  ``--smoke`` changes nothing
here (the run is already small).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

from dmlc_core_tpu_torch.examples import _cli

WORKERS = 4
ROWS = 20_000


def worker(device):
    import torch

    from dmlc_core_tpu_torch.parallel import collectives as coll

    coll.init(backend="gloo")
    rank, world = coll.rank(), coll.world_size()
    rng = np.random.default_rng(rank)          # each worker's shard
    X = rng.normal(size=(ROWS, 10)).astype(np.float32)
    # the shard's histogram, taken where the worker's data lives
    x0 = torch.from_numpy(X[:, 0]).to(device)
    local_hist = torch.histc(x0, bins=32, min=-4.0, max=4.0)
    local_hist = local_hist.cpu().numpy().astype(np.float64)
    global_hist = coll.allreduce(local_hist)
    inside = int(((X[:, 0] >= -4) & (X[:, 0] <= 4)).sum())
    total = int(coll.allreduce(np.array([inside], np.int64))[0])
    assert int(global_hist.sum()) == total, (global_hist.sum(), total)
    print(f"worker {rank}/{world} on {x0.device}: local rows {len(X)}, "
          f"global histogram mass {int(global_hist.sum())}", flush=True)
    coll.barrier()
    coll.finalize()


def main(argv=None):
    args = _cli.parse(__doc__, argv, worker=True)
    device = args.device
    if args.worker:
        worker(device)
        return 0
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep) if q])
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", str(WORKERS),
           "--max-attempts", "1", "--", sys.executable, "-m",
           "dmlc_core_tpu_torch.examples.distributed_local", "--worker",
           "--device", args.device]
    rc = subprocess.run(cmd, env=env, timeout=600).returncode
    print(f"{WORKERS} workers through dmlc-submit --cluster local: "
          f"exit {rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
