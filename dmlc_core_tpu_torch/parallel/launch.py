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
``threads`` (torch intra-op threads per rank), optional ``qid`` (a
``.npy`` of query ids: ``fit(qid=)`` for the ``rank:*`` objectives),
``params`` (``HistGBT``
keyword arguments), ``runs`` (``[{"name", "env"}]``: the ``DMLC_*``
levers of each fit; a run may name its own ``X``/``y``/``cuts``/``Xv``,
``params`` (laid over the job's), and an ``eval`` dict, ``{"X", "y", "early_stopping_rounds"}``, which
fits with that ``eval_set`` and writes ``eval_history``,
``best_iteration`` and ``best_score`` into the run's ``.json``, or an
``external`` dict, ``{"page_rows", "cache_device"}`` (the latter
optional), which trains by ``fit_external`` over this rank's rows,
``shard_row_ranges(n, world)[rank]``, as ``ArrayRowIter`` pages — or,
with a ``"uri"`` (and optional ``"format"``, default ``libsvm``, and
``"num_col"``), over this rank's ``InputSplit`` part of that file,
directory or remote prefix, ``RowBlockIter.create(uri, rank, world,
format)``, parsed by the rank itself (no ``X``/``y`` then; the run's
``.json`` adds the native parse and I/O call counts) — or a
``sparse`` dict, ``{"csr", "n_features", "cuts"}`` (``.npz`` paths: the
global CSR rows ``offset``/``index``/``value``/``y``, and optional
injected cuts ``cut_vals``/``cut_ptr``), which fits a ``SparseHistGBT``
with the run's ``params`` on this rank's CSR rows (no ``X``/``y`` then),
or a ``model`` name, ``gblinear`` or ``fm``, which fits a ``GBLinear`` or
an ``FM`` with the run's ``params`` on the global ``X``/``y`` (and the
job's optional ``weight``, a ``.npy`` of row weights; each rank keeps its
rows) and writes only the model file and the fit's seconds)
and ``out`` (a directory)::

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
    from dmlc_core_tpu_torch.data import _native
    from dmlc_core_tpu_torch.io import _native_io
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
    out.mkdir(parents=True, exist_ok=True)    # a worker dmlc-submit started
    kernels = (H.hist_kernel, H.fused_round_kernel, H.fused_descend_kernel,
               H.descend_kernel)
    for run in job["runs"]:
        name = run["name"]
        data = {**job, **run}             # a run may bring its own rows
        if data.get("sparse"):
            _sparse_run(data, name, rank, device, out)
            continue
        if data.get("model"):
            _model_run(data, name, rank, device, out)
            continue
        ext = data.get("external")
        from_uri = bool(ext and ext.get("uri"))
        X = None if from_uri else np.load(data["X"], mmap_mode="r")
        y = None if from_uri else np.load(data["y"])
        cuts = np.load(data["cuts"]) if data.get("cuts") else None
        Xv = np.load(data["Xv"]) if data.get("Xv") else None
        qid = np.load(data["qid"]) if data.get("qid") else None
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
            _native.reset_calls()
            _native_io.reset_calls()
            if from_uri:
                from dmlc_core_tpu_torch.data.iter import RowBlockIter

                rows = RowBlockIter.create(ext["uri"], rank, coll.world_size(),
                                           ext.get("format", "libsvm"))
                try:
                    model.fit_external(rows, num_col=ext.get("num_col"),
                                       cuts=cuts,
                                       cache_device=ext.get("cache_device",
                                                            False))
                finally:
                    rows.close()
            elif ext:
                from dmlc_core_tpu_torch.data.iter import ArrayRowIter
                from dmlc_core_tpu_torch.parallel.mesh import shard_row_ranges

                lo, hi = shard_row_ranges(len(y), coll.world_size())[rank]
                model.fit_external(
                    ArrayRowIter(np.ascontiguousarray(X[lo:hi]), y[lo:hi],
                                 page_rows=ext["page_rows"]),
                    num_col=X.shape[1], cuts=cuts,
                    cache_device=ext.get("cache_device", False))
            elif ev:
                model.fit(X, y, cuts=cuts,
                          eval_set=(np.load(ev["X"]), np.load(ev["y"])),
                          early_stopping_rounds=ev.get(
                              "early_stopping_rounds", 0))
            else:
                model.fit(X, y, cuts=cuts, qid=qid)
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
                "best_score": model.best_score,
                "descend_launches": H.descend_kernel.launches,
                "native": {**_native.calls(), **_native_io.calls()}}
        margins = (model.train_margins() if model._train_preds is not None
                   else None)
        model.save_model(str(out / f"{name}.{rank}.model"))
        if rank == 0:
            if margins is not None:
                np.save(out / f"{name}.margins.npy", margins)
            if Xv is not None:
                np.save(out / f"{name}.pred.npy",
                        model.predict(Xv, output_margin=True))
        (out / f"{name}.{rank}.json").write_text(json.dumps(stats))
    coll.barrier()
    coll.finalize()


def _sparse_run(data: Dict[str, Any], name: str, rank: int, device: str,
                out: Path) -> None:
    """One rank of a ``sparse`` run: ``SparseHistGBT.fit`` on this rank's
    rows of the global CSR (``shard_row_ranges``), the model file and a
    ``.json`` of the fit's times."""
    import numpy as np

    from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT
    from dmlc_core_tpu_torch.ops.sparse_hist import cuts_from_ptr
    from dmlc_core_tpu_torch.parallel import collectives as coll
    from dmlc_core_tpu_torch.parallel.mesh import shard_row_ranges

    sp = data["sparse"]
    csr = np.load(sp["csr"])
    offset = csr["offset"]
    lo, hi = shard_row_ranges(len(offset) - 1, coll.world_size())[rank]
    a, b = int(offset[lo]), int(offset[hi])
    cuts = None
    if sp.get("cuts"):
        c = np.load(sp["cuts"])
        cuts = cuts_from_ptr(c["cut_vals"], c["cut_ptr"])
    with _levers(data.get("env", {})):
        model = SparseHistGBT(device=device, **data["params"])
        model.fit(offset[lo:hi + 1] - a, csr["index"][a:b],
                  csr["value"][a:b], csr["y"][lo:hi],
                  n_features=sp["n_features"], cuts=cuts)
    model.save_model(str(out / f"{name}.{rank}.model"))
    (out / f"{name}.{rank}.json").write_text(json.dumps({
        "rank": rank, "world": coll.world_size(), "rows": hi - lo,
        "fit_seconds": model.last_fit_seconds}))


def _model_run(data: Dict[str, Any], name: str, rank: int, device: str,
               out: Path) -> None:
    """One rank of a ``gblinear`` or ``fm`` run: the model's ``fit`` on
    the global rows (the model keeps this rank's), its file and a
    ``.json`` of the fit's seconds."""
    import numpy as np

    from dmlc_core_tpu_torch.models.fm import FM
    from dmlc_core_tpu_torch.models.linear import GBLinear
    from dmlc_core_tpu_torch.parallel import collectives as coll

    cls = {"gblinear": GBLinear, "fm": FM}[data["model"]]
    X = np.load(data["X"])
    y = np.load(data["y"])
    weight = np.load(data["weight"]) if data.get("weight") else None
    with _levers(data.get("env", {})):
        model = cls(device=device, **data["params"])
        model.fit(X, y, weight=weight)
    model.save_model(str(out / f"{name}.{rank}.model"))
    (out / f"{name}.{rank}.json").write_text(json.dumps({
        "rank": rank, "world": coll.world_size(),
        "fit_seconds": model.last_fit_seconds}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", required=True,
                    help="job JSON; rank and group from the DMLC_* env")
    args = ap.parse_args(argv)
    run_worker(json.loads(Path(args.worker).read_text()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
