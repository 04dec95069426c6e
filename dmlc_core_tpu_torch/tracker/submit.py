"""dmlc-submit CLI entry point.

Reference parity: ``tracker/dmlc-submit`` → ``dmlc_tracker/submit.py``
(SURVEY.md §2c).  Usage::

    python -m dmlc_core_tpu_torch.tracker.submit --cluster local -n 4 -- \
        python my_worker.py

Workers read the ``DMLC_*`` env ABI (``collectives.init()``) and form a
``torch.distributed`` group; run one worker per GPU.  Workers inherit
this process's environment (``CUDA_VISIBLE_DEVICES`` included) under the
env ABI (``launch.LocalTransport``).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, set_log_level
from dmlc_core_tpu_torch.launch.config import SUPERVISED_CLUSTERS, jobset_from_opts
from dmlc_core_tpu_torch.tracker.opts import get_opts
from dmlc_core_tpu_torch.tracker.tracker import submit as tracker_submit

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    """dmlc-submit entry point: parse opts, start the tracker, and launch
    workers on the selected cluster backend (reference
    dmlc_tracker/submit.py)."""
    opts, command = get_opts(argv)
    set_log_level(opts.log_level)
    CHECK(len(command) > 0, "no worker command given (use: dmlc-submit ... -- cmd)")
    extra_env = dict(kv.split("=", 1) for kv in opts.env)
    exit_codes: List[int] = []

    def fun_submit(n_total: int, envs) -> None:
        envs = {**envs, **extra_env}
        nw = opts.num_workers
        if opts.cluster in SUPERVISED_CLUSTERS:
            # local/ssh/kubernetes are configurations of the same
            # supervised JobSet — only the transport differs
            exit_codes.extend(jobset_from_opts(opts, command, envs).run())
        elif opts.cluster == "mpi":
            from dmlc_core_tpu_torch.tracker import mpi as be
            exit_codes.extend(be.launch(nw, command, envs, host_file=opts.host_file))
        elif opts.cluster == "sge":
            from dmlc_core_tpu_torch.tracker import sge as be
            exit_codes.extend(be.launch(
                nw, command, envs, queue=opts.queue, jobname=opts.jobname,
                worker_cores=opts.worker_cores))
        elif opts.cluster == "slurm":
            from dmlc_core_tpu_torch.tracker import slurm as be
            exit_codes.extend(be.launch(
                nw, command, envs, queue=opts.queue, jobname=opts.jobname,
                worker_cores=opts.worker_cores, worker_memory_mb=opts.worker_memory))
        elif opts.cluster == "yarn":
            from dmlc_core_tpu_torch.tracker import yarn as be
            exit_codes.extend(be.launch(
                nw, command, envs, queue=opts.queue, jobname=opts.jobname,
                worker_cores=opts.worker_cores or 1,
                worker_memory_mb=opts.worker_memory or 1024))
        elif opts.cluster == "mesos":
            from dmlc_core_tpu_torch.tracker import mesos as be
            exit_codes.extend(be.launch(
                nw, command, envs, master=opts.mesos_master, jobname=opts.jobname,
                worker_cores=opts.worker_cores or 1,
                worker_memory_mb=opts.worker_memory or 1024))

    tracker = tracker_submit(
        opts.num_workers,
        opts.num_servers,
        fun_submit,
        host_ip=opts.host_ip,
        start_tracker=opts.start_legacy_tracker,
    )
    if tracker is not None:
        tracker.stop()
    return 0 if all(c == 0 for c in exit_codes) else 1


if __name__ == "__main__":
    sys.exit(main())
