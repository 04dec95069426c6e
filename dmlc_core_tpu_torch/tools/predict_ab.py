#!/usr/bin/env python3
"""Time a served batch and ``predict`` of one checkout of the port, or A/B two.

    python3 dmlc_core_tpu_torch/tools/predict_ab.py [--root DIR]
    python3 dmlc_core_tpu_torch/tools/predict_ab.py --ab BASE_DIR

One run fits two models on the card through the package found under
``--root`` (default: the checkout holding this file): configuration 1's
(loss-guide 16, depth 6, 256 bins, 5 trees, the bench's levers, on
``FIT_ROWS`` HIGGS-like rows of ``chip_smoke.py``'s rule) and the port
bench's ``--serve`` model (20 trees of depth 4, 64 bins, 50,000 normal
rows, seed 11).  For each it times ``ModelRunner.predict`` at every bucket
of the serve ladder 8..256 after ``warmup()`` (host clock around the call,
which returns host arrays: median of ``--reps``), counts the kernel
launches of one batch (``descend_kernel``'s and, where the package has
it, ``forest_kernel``'s), and times ``HistGBT.predict`` of
``PREDICT_ROWS`` rows (median of 3); it prints one JSON line with the
card's name and power limit (``--device cpu`` rehearses a run on the
host: no device number).  ``--ab`` runs BASE_DIR, this checkout, this
checkout, BASE_DIR, each in its own process on the same card, then prints
each time of this checkout over BASE_DIR's (the two runs of each
averaged).  Only the API both sides share is used.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FIT_ROWS = 200_000
PREDICT_ROWS = 1_000_000
LADDER = (8, 16, 32, 64, 128, 256)


def this_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its data rule and levers),
    imported before ``root`` goes on the path, so that both sides of an
    A/B fit the same models."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def launches(H):
    """``descend_kernel``'s and ``forest_kernel``'s launches so far (the
    latter 0 in a tree without it)."""
    try:
        from dmlc_core_tpu_torch.ops.forest import forest_kernel
        forest = forest_kernel.launches
    except ImportError:
        forest = 0
    return {"descend": H.descend_kernel.launches, "forest": forest}


def run_one(root, reps, device="cuda"):
    c = this_chip_smoke()
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.serve.runner import ModelRunner
    from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

    if not os.path.abspath(H.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {H.__file__}, not from {root}")
    X, y = c.higgs_like(np, FIT_ROWS, c.FEATURES, 7)
    with c.levers(c.BENCH_LEVERS):
        config1 = HistGBT(n_trees=5, max_depth=6, n_bins=256,
                          device=device).fit(X, y)
    rng = np.random.default_rng(11)
    Xs = rng.normal(size=(50_000, c.FEATURES)).astype(np.float32)
    ys = (Xs[:, 0] * Xs[:, 1] + 0.5 * Xs[:, 2] > 0).astype(np.float32)
    serve = HistGBT(n_trees=20, max_depth=4, n_bins=64, learning_rate=0.3,
                    device=device).fit(Xs, ys)
    Xq, _ = c.higgs_like(np, PREDICT_ROWS, c.FEATURES, 8)
    out = {"root": root, "models": {},
           "card": (gpu_name_and_power_limit() if device != "cpu"
                    else "cpu (a rehearsal: no device number)")}
    for name, model in (("configuration_1", config1), ("serve_bench", serve)):
        runner = ModelRunner(model, max_batch=LADDER[-1],
                             min_bucket=LADDER[0], name=name)
        runner.warmup()
        before = launches(H)
        runner.predict(Xq[:LADDER[-1]])
        after = launches(H)
        bucket_ms = {}
        for b in LADDER:
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                runner.predict(Xq[:b])
                times.append((time.perf_counter() - t0) * 1e3)
            bucket_ms[b] = statistics.median(times)
        model.predict(Xq[:1000])
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.predict(Xq)
            times.append(time.perf_counter() - t0)
        out["models"][name] = {
            "trees": len(model.trees), "depth": model.param.max_depth,
            "launches_a_batch": {k: after[k] - before[k] for k in after},
            "bucket_ms": bucket_ms,
            "predict_1m_ms": statistics.median(times) * 1e3}
    print(json.dumps(out), flush=True)


def run_ab(base, reps):
    runs = []
    for root in (base, ROOT, ROOT, base):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--reps", str(reps)],
            check=True, capture_output=True, text=True, timeout=900)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))

    def flat(r):
        return {f"{m}_{k}": v for m, rec in r["models"].items()
                for k, v in [*(("b" + str(b), t) for b, t in
                               rec["bucket_ms"].items()),
                             ("predict_1m", rec["predict_1m_ms"])]}

    b = [flat(runs[0]), flat(runs[3])]
    t = [flat(runs[1]), flat(runs[2])]
    print(json.dumps({"ratio_this_over_base": {
        k: (t[0][k] + t[1][k]) / (b[0][k] + b[1][k]) for k in b[0]}}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ab", metavar="BASE_DIR")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses one run (no --ab)")
    args = ap.parse_args()
    if args.ab:
        run_ab(os.path.abspath(args.ab), args.reps)
    else:
        run_one(os.path.abspath(args.root), args.reps, args.device)


if __name__ == "__main__":
    main()
