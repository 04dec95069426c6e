#!/usr/bin/env python3
"""SparseHistGBT bench: a synthetic 100k-feature sparse workload.

    python3 -m dmlc_core_tpu_torch.tools.bench_sparse [--device cpu]

The counterpart of ``scripts/bench_sparse.py``, with its data rule and
knobs: bag-of-words-shaped rows (F = 100k at density 0.5%), where the
dense engine's ``[F, n]`` bin matrix (n·F = 10^10 cells) cannot exist and
the ragged sparse path touches only the present entries.  Power-law
feature popularity (``1/k^0.7``) over features 2..F-1, duplicates within
a row dropped; features 0 and 1 are present in every row with N(0, 1)
values and carry the label ``v0 + 0.5·v1 > 0``; seed 0.

Knobs (the JAX script's): ``SPARSE_ROWS`` (1e5), ``SPARSE_F`` (1e5),
``SPARSE_DENSITY`` (0.005), ``SPARSE_ROUNDS`` (20), ``SPARSE_BINS`` (32),
``SPARSE_DEPTH`` (6); ``DMLC_TPU_SPARSE_ROUNDS_PER_DISPATCH`` rounds run
between host fetches.  A warm-up fit of one chunk (the first use of every
torch op, and of the tail chunk's length) runs before the timed fit, as
in the JAX script.  Prints one JSON line with the JAX script's fields
(``metric: "sparse_histgbt_rounds_per_sec"``, ``value`` = rounds over the
timed fit's wall, which includes the fit's host set-up — cuts, entry
binning, upload — as the JAX script's does; ``rows``, ``features``,
``nnz``, ``total_bins``, ``fit_seconds``, ``predict_seconds``,
``train_acc``, ...) plus ``device``, the card's name and power limit.  It
runs on the card; ``--device cpu`` runs the same on the host, a rehearsal
whose times are no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def knobs() -> dict:
    """The JAX script's ``SPARSE_*`` knobs with its defaults."""
    env = os.environ
    return {"n": int(float(env.get("SPARSE_ROWS", 100_000))),
            "F": int(float(env.get("SPARSE_F", 100_000))),
            "density": float(env.get("SPARSE_DENSITY", 0.005)),
            "rounds": int(env.get("SPARSE_ROUNDS", 20)),
            "n_bins": int(env.get("SPARSE_BINS", 32)),
            "depth": int(env.get("SPARSE_DEPTH", 6))}


def sparse_data(n: int, F: int, density: float, seed: int = 0):
    """The JAX script's rows: CSR ``(offset, index, value)`` and labels
    ``y`` (its generator, draw for draw)."""
    nnz_per_row = max(2, int(F * density))
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, F - 1) ** 0.7
    pop /= pop.sum()
    draw = rng.choice(F - 2, size=(n, nnz_per_row - 2), p=pop) + 2
    draw.sort(axis=1)
    first = np.concatenate([np.ones((n, 1), bool),
                            draw[:, 1:] != draw[:, :-1]], axis=1)
    sel_idx = draw[first].astype(np.int64)
    sel_val = rng.normal(size=len(sel_idx)).astype(np.float32)
    counts = first.sum(axis=1)
    offset = np.concatenate([[0], np.cumsum(counts + 2)]).astype(np.int64)
    total = int(offset[-1])
    v0 = rng.normal(size=n).astype(np.float32)
    v1 = rng.normal(size=n).astype(np.float32)
    index = np.empty(total, np.int64)
    value = np.empty(total, np.float32)
    starts = offset[:-1]
    index[starts] = 0
    index[starts + 1] = 1
    value[starts] = v0
    value[starts + 1] = v1
    rows_sel = np.repeat(np.arange(n), counts)
    rank = (np.arange(len(sel_idx))
            - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                        counts))
    pos = starts[rows_sel] + 2 + rank
    index[pos] = sel_idx
    value[pos] = sel_val
    y = (v0 + 0.5 * v1 > 0).astype(np.float32)
    return offset, index, value, y


def run(device: str = "cuda", data=None) -> dict:
    """One bench run at the knobs (``data``: their rows, when already
    made): the record as a dict, and the fitted model under
    ``"_model"``."""
    sys.path.insert(0, ROOT)
    import torch

    from dmlc_core_tpu_torch.models.histgbt_sparse import (ROUNDS_KNOB,
                                                           SparseHistGBT)
    from dmlc_core_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                  resolve_device)

    dev = resolve_device(device)
    k = knobs()
    n, F, rounds = k["n"], k["F"], k["rounds"]
    t0 = time.perf_counter()
    offset, index, value, y = (sparse_data(n, F, k["density"])
                               if data is None else data)
    gen_s = time.perf_counter() - t0
    kw = dict(max_depth=k["depth"], n_bins=k["n_bins"], learning_rate=0.3,
              device=dev)
    K = int(os.environ.get(ROUNDS_KNOB, "8"))
    t0 = time.perf_counter()
    SparseHistGBT(n_trees=min(rounds, K), **kw).fit(
        offset, index, value, y, n_features=F)
    if rounds > K and rounds % K:
        SparseHistGBT(n_trees=rounds % K, **kw).fit(
            offset, index, value, y, n_features=F)
    warmup_s = time.perf_counter() - t0
    m = SparseHistGBT(n_trees=rounds, **kw)
    t0 = time.perf_counter()
    m.fit(offset, index, value, y, n_features=F)
    fit_s = time.perf_counter() - t0
    pred = m.predict(offset, index, value)         # first use of its ops
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pred = m.predict(offset, index, value)
    pred_s = time.perf_counter() - t0
    acc = float(((pred > 0.5) == y).mean())
    return {
        "metric": "sparse_histgbt_rounds_per_sec",
        "value": round(rounds / fit_s, 4),
        "unit": "rounds/s",
        "rows": n, "features": F, "nnz": int(offset[-1]),
        "density": round(float(offset[-1]) / (n * F), 5),
        "total_bins": m.cuts.total_bins,
        "dense_bins_would_be": F * k["n_bins"],
        "n_bins": k["n_bins"], "depth": k["depth"], "rounds": rounds,
        "gen_seconds": round(gen_s, 2),
        "warmup_seconds": round(warmup_s, 2),
        "fit_seconds": round(fit_s, 2),
        "setup_seconds": round(m.last_setup_seconds, 2),
        "predict_seconds": round(pred_s, 2),
        "predict_rows_per_sec": round(n / pred_s, 1),
        "train_acc": round(acc, 4),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (gpu_name_and_power_limit() if dev.type == "cuda"
                   else "cpu"),
        "_model": m,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.device)
    rec.pop("_model")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
