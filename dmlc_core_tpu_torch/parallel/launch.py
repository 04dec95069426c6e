"""Start a data-parallel ``HistGBT`` fit as local processes, one per rank.

The counterpart of ``dmlc-submit --cluster local`` for the port: each rank
is a process that receives the reference's ``DMLC_*`` env ABI
(``DMLC_NUM_WORKER``, ``DMLC_TASK_ID``, ``DMLC_TRACKER_URI``,
``DMLC_TRACKER_PORT``), joins the group through
:func:`~dmlc_core_tpu_torch.parallel.collectives.init` and runs a list of
fits on the same global rows, writing per rank and fit:

* ``<name>.<rank>.model`` — the ``save_model`` file;
* ``<name>.<rank>.json`` — kernel launch counts, the fit's times, the
  histogram-sync bytes recorded and the device all-reduces issued;
* ``<name>.margins.npy`` (rank 0) — ``train_margins()``, global order;
* ``<name>.pred.npy`` (rank 0, with ``"Xv"``) — ``predict`` margins.

A job is a JSON dict: ``X``/``y`` (``.npy`` paths, the global rows),
optional ``cuts`` and ``Xv``, ``backend`` (``nccl``, or ``gloo`` for CPU
tensors and several ranks on one card), ``device`` (``cpu``, a card such
as ``cuda:0`` for every rank, or ``cuda`` for ``cuda:<rank>``),
``threads`` (torch intra-op threads per rank), ``params`` (``HistGBT``
keyword arguments), ``runs`` (``[{"name", "env"}]``: the ``DMLC_*``
levers of each fit; a run may name its own ``X``/``y``/``cuts``/``Xv``,
``params`` (laid over the job's), and an ``eval`` dict, ``{"X", "y", "early_stopping_rounds"}``, which
fits with that ``eval_set`` and writes ``eval_history``,
``best_iteration`` and ``best_score`` into the run's ``.json``) and
``out`` (a directory)::

    launch(job, world=2, timeout=120)

or, for one rank started by another launcher,
``python -m dmlc_core_tpu_torch.parallel.launch --worker job.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["launch", "run_ranks", "free_port", "run_worker"]

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port the OS reports free on 127.0.0.1 (for the rendezvous
    of one group)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: Dict[str, Any], world: int, timeout: float,
           env: Optional[Dict[str, str]] = None) -> None:
    """Run ``job`` on ``world`` local ranks and wait for all of them
    (see :func:`run_ranks`)."""
    out = Path(job["out"]).resolve()
    out.mkdir(parents=True, exist_ok=True)
    job_path = out / "job.json"
    job_path.write_text(json.dumps(job))
    run_ranks([sys.executable, "-m", "dmlc_core_tpu_torch.parallel.launch",
               "--worker", str(job_path)], world, timeout, out, env)


def run_ranks(cmd: List[str], world: int, timeout: float, log_dir: Path,
              env: Optional[Dict[str, str]] = None) -> None:
    """Start ``cmd`` as ``world`` processes, each with the ``DMLC_*`` env
    ABI of its rank (rendezvous on a free port of 127.0.0.1, this
    checkout on ``PYTHONPATH``, output to ``log_dir/rank<r>.log``), and
    wait for all of them.

    Raises ``RuntimeError`` (with every rank's last output) when a rank
    exits non-zero or the group is not done within ``timeout`` seconds;
    every rank still running is killed first."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH")
                       else []))
    base.update({"DMLC_NUM_WORKER": str(world),
                 "DMLC_TRACKER_URI": "127.0.0.1",
                 "DMLC_TRACKER_PORT": str(free_port())})
    procs = []
    deadline = time.monotonic() + timeout
    failed = None
    try:
        for r in range(world):
            log = open(log_dir / f"rank{r}.log", "w+")
            try:
                proc = subprocess.Popen(
                    cmd, env={**base, "DMLC_TASK_ID": str(r)}, stdout=log,
                    stderr=subprocess.STDOUT)
            except BaseException:
                log.close()
                raise
            procs.append((proc, log))
        # poll every rank: one that dies leaves its peers waiting in a
        # collective, so the first failure ends the group
        while failed is None:
            rcs = [proc.poll() for proc, _ in procs]
            bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit code {rcs[bad[0]]}")
            elif all(rc == 0 for rc in rcs):
                break
            elif time.monotonic() > deadline:
                failed = (rcs.index(None), f"timed out after {timeout} s")
            else:
                time.sleep(0.05)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed is not None:
        tails = []
        for r in range(world):
            text = (log_dir / f"rank{r}.log").read_text(errors="replace")
            tails.append(f"--- rank {r} ---\n{text[-3000:]}")
        raise RuntimeError(
            f"data-parallel job failed: rank {failed[0]} {failed[1]}\n"
            + "\n".join(tails))


@contextlib.contextmanager
def _levers(env: Dict[str, str]):
    """The fit's ``DMLC_*`` levers set for a block, restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _metric(name: str, **labels) -> float:
    from dmlc_core_tpu_torch.base.metrics import default_registry

    snap = default_registry().snapshot()["metrics"].get(f"dmlc_{name}")
    if snap is None:
        return 0.0
    return sum(s["value"] for s in snap["series"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def run_worker(job: Dict[str, Any]) -> None:
    """One rank of :func:`launch` (rank and group from the env ABI)."""
    import numpy as np
    import torch

    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.parallel import collectives as coll

    torch.set_num_threads(int(job.get("threads", 1)))
    rank = int(os.environ["DMLC_TASK_ID"])
    device = job["device"]
    if device == "cuda":
        device = f"cuda:{rank}"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    coll.init(backend=job["backend"])
    out = Path(job["out"])
    kernels = (H.hist_kernel, H.fused_round_kernel, H.fused_descend_kernel,
               H.descend_kernel)
    for run in job["runs"]:
        name = run["name"]
        data = {**job, **run}             # a run may bring its own rows
        X = np.load(data["X"], mmap_mode="r")
        y = np.load(data["y"])
        cuts = np.load(data["cuts"]) if data.get("cuts") else None
        Xv = np.load(data["Xv"]) if data.get("Xv") else None
        with _levers(run.get("env", {})):
            for k in kernels:
                k.launches = 0
                for extra in ("layout_launches", "dir_launches"):
                    if hasattr(k, extra):
                        setattr(k, extra, 0)
            calls0 = _metric("collective_calls_total", op="device_allreduce")
            bytes0 = _metric("histogram_psum_bytes_total", engine="incore")
            model = HistGBT(device=device,
                            **{**job["params"], **run.get("params", {})})
            ev = data.get("eval")
            if ev:
                model.fit(X, y, cuts=cuts,
                          eval_set=(np.load(ev["X"]), np.load(ev["y"])),
                          early_stopping_rounds=ev.get(
                              "early_stopping_rounds", 0))
            else:
                model.fit(X, y, cuts=cuts)
            launches = {
                "hist": H.hist_kernel.launches,
                "hist_layout": H.hist_kernel.layout_launches,
                "fused_round": H.fused_round_kernel.launches,
                "fused_round_layout": H.fused_round_kernel.layout_launches,
                "fused_descend": H.fused_descend_kernel.launches,
                "descend_dir": H.descend_kernel.dir_launches}
            stats = {
                "rank": rank, "world": coll.world_size(),
                "launches": launches,
                "fit_seconds": model.last_fit_seconds,
                "tree_times": model.last_tree_times,
                "bin_seconds": model.last_bin_seconds,
                "device_allreduces": _metric(
                    "collective_calls_total",
                    op="device_allreduce") - calls0,
                "hist_sync_bytes": _metric(
                    "histogram_psum_bytes_total", engine="incore") - bytes0,
                "layout": model._bin_layout is not None,
                "missing": model._missing,
                "eval_history": model.eval_history,
                "best_iteration": model.best_iteration,
                "best_score": model.best_score}
        margins = model.train_margins()
        model.save_model(str(out / f"{name}.{rank}.model"))
        if rank == 0:
            np.save(out / f"{name}.margins.npy", margins)
            if Xv is not None:
                np.save(out / f"{name}.pred.npy",
                        model.predict(Xv, output_margin=True))
        (out / f"{name}.{rank}.json").write_text(json.dumps(stats))
    coll.barrier()
    coll.finalize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", required=True,
                    help="job JSON; rank and group from the DMLC_* env")
    args = ap.parse_args(argv)
    run_worker(json.loads(Path(args.worker).read_text()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
