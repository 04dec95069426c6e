"""Multi-card parity drill of the data-parallel ``HistGBT`` data plane.

    python -m dmlc_core_tpu_torch.tools.check_multichip [--device DEV] [--out PATH]

The port's counterpart of the repository's ``scripts/check_multichip.py``,
with its rows (10,007 × 12, seed 7: odd, so the remainder and tail paths
run), depth 4, 32 bins, 6 rounds, report keys and exit code.  A fit on one
process (no process group) is the oracle; ``MULTICHIP_DEVICES`` (8) ranks,
one process each, then prove three bit-parity contracts:

1. **1-rank oracle**: the N-rank data-parallel fit of the same global rows
   and cuts writes (``save_model``) the oracle's bytes on every rank, and
   every rank used the oracle's cut bytes (cuts that differ by one bit on
   one rank are a failure here, not a silent drift);
2. **Sharded ingest**: each rank bins its own
   ``shard_row_ranges(n, world)`` slab with the shared cuts
   (``make_device_data`` keeps and bins only this rank's rows); the
   ranks' slabs concatenated equal the one-process bin matrix bit for bit,
   and the fits from those handles write the oracle's bytes.  JAX stages
   the same rows either by one global put or per device from one process;
   the port has no global put (one process per card, each holding its own
   rows), so the per-rank slabs are the contract;
3. **Out-of-core**: each rank streams its slab through
   ``make_device_data_iter`` as 1024-row slabs (JAX's
   ``DMLC_INGEST_CHUNK_ROWS=1024``: here the slab source yields them); the
   bins and the files equal (2)'s.

``--device cpu`` runs gloo ranks on the CPU (the tests' form); ``--device
cuda`` (the default) one rank per card over NCCL, ``cuda:<rank>``, and
raises when fewer cards are visible than ranks are asked for; ``--device
cuda:K`` runs gloo ranks sharing card K.  The report: JAX's keys, with
``deterministic_hist_blocks`` null (the int64 histogram sync is exact
without blocks), ``rounds_per_sec_per_chip`` at 1 and N (each from the
fit's wall, as JAX times ``fit``), ``scaling_efficiency_cpu`` filled on
``cpu`` only (ranks sharing the host's cores: an engine-overhead floor,
not a hardware claim), plus the device, the backend, the cut check and
each rank's launches.  Exit 0 when every parity holds; the report goes
to ``--out`` / ``MULTICHIP_OUT`` (default ``$TMPDIR/
multichip_scaling.json``) and to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ROWS, FEATURES = 10_007, 12
DEPTH, N_BINS, ROUNDS = 4, 32, 6
SLAB_ROWS = 1024
RANK_TIMEOUT = 600
KW = dict(n_trees=ROUNDS, max_depth=DEPTH, n_bins=N_BINS, learning_rate=0.3)


def check_rows() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The check's rows, labels and cuts (the JAX script's rule)."""
    import torch

    from dmlc_core_tpu_torch.ops.quantile import compute_cuts

    rng = np.random.default_rng(7)
    X = rng.normal(size=(ROWS, FEATURES)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    cuts = compute_cuts(torch.from_numpy(X), N_BINS).numpy()
    return X, y, cuts


def _model_bytes(model) -> bytes:
    d = tempfile.mkdtemp(prefix="multichip_model_")
    try:
        path = os.path.join(d, "m.gbt")
        model.save_model(path)
        return Path(path).read_bytes()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _launches() -> Dict[str, int]:
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.ops.forest import forest_kernel

    return {"hist": H.hist_kernel.launches,
            "fused_round": H.fused_round_kernel.launches,
            "fused_descend": H.fused_descend_kernel.launches,
            "descend": H.descend_kernel.launches,
            "forest": forest_kernel.launches}


def _rank_worker(d: Path) -> None:
    """One rank (``--rank-worker DIR``): the three fits on this rank's
    share, their files, bins and cuts written into ``DIR``."""
    import torch

    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.parallel import collectives as coll
    from dmlc_core_tpu_torch.parallel.mesh import shard_row_ranges

    job = json.loads((d / "job.json").read_text())
    rank = int(os.environ["DMLC_TASK_ID"])
    device = job["device"]
    if device == "cuda":
        device = f"cuda:{rank}"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    torch.set_num_threads(job["threads"])
    coll.init(backend=job["backend"])
    world = coll.world_size()
    X = np.load(d / "X.npy")
    y = np.load(d / "y.npy")
    own = d / f"cuts.{rank}.npy"
    cuts = np.load(own if own.exists() else d / "cuts.npy")

    def sync():
        if device.startswith("cuda"):
            torch.cuda.synchronize(device)

    # (1) the data-parallel fit of the global rows
    mN = HistGBT(device=device, **KW)
    t0 = time.perf_counter()
    mN.fit(X, y, cuts=cuts)
    sync()
    fit_seconds = time.perf_counter() - t0
    (d / f"oracle.{rank}.model").write_bytes(_model_bytes(mN))
    np.save(d / f"cuts_used.{rank}.npy", mN.cuts.cpu().numpy())
    # (2) this rank's slab, binned with the shared cuts
    mS = HistGBT(device=device, **KW)
    ddS = mS.make_device_data(X, y, cuts=cuts)
    np.save(d / f"bins.{rank}.npy", ddS["bins_t"].cpu().numpy())
    mS.fit_device(ddS)
    (d / f"ingest.{rank}.model").write_bytes(_model_bytes(mS))
    # (3) the same slab streamed as SLAB_ROWS-row slabs
    lo, hi = shard_row_ranges(len(y), world)[rank]
    step = job["slab_rows"]

    def slabs():
        for a in range(lo, hi, step):
            b = min(a + step, hi)
            yield X[a:b], y[a:b], None

    mO = HistGBT(device=device, **KW)
    ddO = mO.make_device_data_iter(slabs, n_features=X.shape[1], cuts=cuts,
                                   n_rows=hi - lo)
    np.save(d / f"ooc_bins.{rank}.npy", ddO["bins_t"].cpu().numpy())
    mO.fit_device(ddO)
    (d / f"ooc.{rank}.model").write_bytes(_model_bytes(mO))
    (d / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "world": world, "device": device,
        "fit_seconds": fit_seconds, "launches": _launches()}))
    coll.barrier()
    coll.finalize()


def _oracle(device: str, X: np.ndarray, y: np.ndarray, cuts: np.ndarray):
    """The one-process fit: ``(its wall seconds, its file, its cuts, the
    one-process bin matrix)``."""
    import torch

    from dmlc_core_tpu_torch.models import HistGBT

    m1 = HistGBT(device=device, **KW)
    t0 = time.perf_counter()
    m1.fit(X, y, cuts=cuts)
    if device.startswith("cuda"):
        torch.cuda.synchronize(device)
    t1 = time.perf_counter() - t0
    bins1 = HistGBT(device=device, **KW).make_device_data(
        X, y, cuts=cuts)["bins_t"].cpu().numpy()
    return t1, _model_bytes(m1), m1.cuts.cpu().numpy(), bins1


def _placement(device: str, n_dev: int) -> Tuple[str, str, str]:
    """``(the oracle's device, the ranks' device, backend)``."""
    import torch

    from dmlc_core_tpu_torch.base.logging import CHECK
    from dmlc_core_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)          # raises without a GPU
    if dev.type == "cpu":
        return "cpu", "cpu", "gloo"
    if device == "cuda":
        CHECK(torch.cuda.device_count() >= n_dev,
              f"check_multichip --device cuda: {n_dev} ranks asked for, "
              f"{torch.cuda.device_count()} cards visible (one rank a card; "
              f"--device cuda:K runs the ranks on card K)")
        return "cuda:0", "cuda", "nccl"
    return str(dev), str(dev), "gloo"


def run(n_dev: int, device: str = "cuda", out_path: Optional[str] = None,
        rank_cuts: Optional[Dict[int, np.ndarray]] = None
        ) -> Tuple[dict, List[str]]:
    """The whole check: the oracle in this process, ``n_dev`` ranks as
    child processes; returns ``(report, failures)``.  ``rank_cuts``
    gives a rank cuts of its own in place of the shared ones (a planted
    difference, which contract 1 must catch)."""
    import torch

    from dmlc_core_tpu_torch.ops.histogram import hist_psum_bytes_per_round
    from dmlc_core_tpu_torch.parallel.launch import run_ranks

    one_dev, rank_dev, backend = _placement(device, n_dev)
    X, y, cuts = check_rows()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # as each rank
    try:
        t1, want, want_cuts, bins1 = _oracle(one_dev, X, y, cuts)
    finally:
        torch.set_num_threads(threads)


    d = Path(tempfile.mkdtemp(prefix="multichip_"))
    try:
        np.save(d / "X.npy", X)
        np.save(d / "y.npy", y)
        np.save(d / "cuts.npy", cuts)
        for r, c in (rank_cuts or {}).items():
            np.save(d / f"cuts.{r}.npy", c)
        (d / "job.json").write_text(json.dumps({
            "device": rank_dev, "backend": backend, "threads": 1,
            "slab_rows": SLAB_ROWS}))
        run_ranks([sys.executable, "-m",
                   "dmlc_core_tpu_torch.tools.check_multichip",
                   "--rank-worker", str(d)], n_dev, RANK_TIMEOUT, d / "logs")
        ranks = range(n_dev)
        stats = [json.loads((d / f"rank{r}.json").read_text())
                 for r in ranks]
        files = {k: [(d / f"{k}.{r}.model").read_bytes() for r in ranks]
                 for k in ("oracle", "ingest", "ooc")}
        cuts_ok = all(np.load(d / f"cuts_used.{r}.npy").tobytes()
                      == want_cuts.tobytes() for r in ranks)
        bins = np.concatenate([np.load(d / f"bins.{r}.npy") for r in ranks],
                              axis=1)
        ooc_bins = np.concatenate(
            [np.load(d / f"ooc_bins.{r}.npy") for r in ranks], axis=1)
    finally:
        shutil.rmtree(d, ignore_errors=True)

    tN = stats[0]["fit_seconds"]
    oracle_ok = cuts_ok and all(f == want for f in files["oracle"])
    ingest_ok = (np.array_equal(bins, bins1)
                 and all(f == want for f in files["ingest"]))
    ooc_ok = (np.array_equal(ooc_bins, bins)
              and files["ooc"] == files["ingest"])
    report = {
        "check": "multichip_scaling", "n_devices": n_dev, "rows": ROWS,
        "features": FEATURES, "rounds": ROUNDS,
        "deterministic_hist_blocks": None,
        "hist_psum_bytes_per_round":
            hist_psum_bytes_per_round(DEPTH, FEATURES, N_BINS),
        "parity": {"ensemble_bytes_equal_1_vs_n": oracle_ok,
                   "sharded_ingest_bit_identical": ingest_ok,
                   "out_of_core_bit_identical": ooc_ok},
        "rounds_per_sec_per_chip": {
            "1": round(ROUNDS / t1, 3),
            str(n_dev): round(ROUNDS / tN / n_dev, 3)},
        # ranks sharing the host's cores: an engine-overhead floor, not a
        # hardware claim; on cards the two rates above are the evidence
        "scaling_efficiency_cpu": (round((ROUNDS / tN / n_dev)
                                         / (ROUNDS / t1), 4)
                                   if rank_dev == "cpu" else None),
        "device": rank_dev, "oracle_device": one_dev, "backend": backend,
        "cut_bytes_equal_across_ranks": cuts_ok,
        "rank_devices": [s["device"] for s in stats],
        "launches": [s["launches"] for s in stats],
        "fit_seconds": {"1": t1, str(n_dev): tN},
    }
    if rank_dev.startswith("cuda"):
        from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

        report["nvidia_smi"] = gpu_name_and_power_limit()
    failures = []
    if not cuts_ok:
        failures.append("a rank's cut bytes differ from the oracle's")
    if not oracle_ok:
        failures.append("1-rank oracle ensemble bytes differ")
    if not ingest_ok:
        failures.append("per-rank slab ingest diverged from the one-process "
                        "bin matrix or file")
    if not ooc_ok:
        failures.append("out-of-core streamed ingest diverged")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (a rank a card, NCCL) or cuda:K (gloo "
                         "ranks sharing card K)")
    ap.add_argument("--out", default=os.environ.get(
        "MULTICHIP_OUT", os.path.join(tempfile.gettempdir(),
                                      "multichip_scaling.json")))
    ap.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        _rank_worker(Path(args.rank_worker))
        return 0
    n_dev = int(os.environ.get("MULTICHIP_DEVICES", 8))
    report, failures = run(n_dev, args.device, args.out)
    print(json.dumps(report))
    if failures:
        for msg in failures:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1
    print(f"multichip parity OK: report archived at {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
