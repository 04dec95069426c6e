#!/usr/bin/env python3
"""Time the histogram kernels of one checkout of the port, or A/B two.

    python3 dmlc_core_tpu_torch/tools/kernel_ab.py [--root DIR]
    python3 dmlc_core_tpu_torch/tools/kernel_ab.py --ab BASE_DIR

One run times ``hist_kernel`` at the root and ``fused_round_kernel`` at
``N_PREV`` parents on random ``[28, 10M]`` bins with 256 bins and no bin
layout (the flagship's shapes), through the package found under ``--root``
(default: the checkout holding this file), with CUDA events (median of
``--reps`` after one warm-up), and prints one JSON line with the card's
name and power limit.  ``--ab`` runs BASE_DIR, this checkout, this
checkout, BASE_DIR, each in its own process on the same card, then prints
the time of each kernel in this checkout over its time in BASE_DIR (the
two runs of each averaged).  ``--profile`` adds each CUDA kernel's mean
device time inside ``hist`` and ``fused_round`` at n_prev 1, from a
``torch.profiler`` trace.  Only the API both sides share is used.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ROWS, FEATURES, N_BINS = 10_000_000, 28, 256
N_PREV = (1, 2, 4, 8, 16, 64)
SEED = 0


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_times(torch, fn, reps):
    """Mean device time (us) of each CUDA kernel ``fn`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = evt.cuda_time_total
        if total > 0:
            times[evt.key[:60]] = total / reps
    return times


def run_one(root, rows, reps, profile=False):
    sys.path.insert(0, root)
    import torch

    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

    if not os.path.abspath(H.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {H.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bins = torch.randint(0, N_BINS, (FEATURES, rows), dtype=torch.uint8,
                         device=dev, generator=gen)
    p = torch.sigmoid(0.5 * torch.randn(rows, device=dev, generator=gen))
    y = (torch.rand(rows, device=dev, generator=gen) < p).float()
    g, h = p - y, p * (1 - p)
    kg, kh = H.hist_scales(g, h)
    root_node = torch.zeros(rows, dtype=torch.int32, device=dev)
    out = {"root": root, "nvidia_smi": gpu_name_and_power_limit(),
           "rows": rows, "features": FEATURES, "n_bins": N_BINS,
           "hist_ms": time_ms(torch, lambda: H.hist_kernel(
               bins, root_node, g, h, 1, N_BINS, kg, kh), reps),
           "fused_round_ms": {}}
    if profile:
        out["hist_kernels_us"] = device_times(
            torch, lambda: H.hist_kernel(bins, root_node, g, h, 1, N_BINS,
                                         kg, kh), reps)
    for n_prev in N_PREV:
        nd = torch.randint(0, n_prev, (rows,), dtype=torch.int32,
                           device=dev, generator=gen)
        feat = torch.randint(0, FEATURES, (n_prev,), dtype=torch.int32,
                             device=dev, generator=gen)
        thr = torch.randint(0, N_BINS - 1, (n_prev,), dtype=torch.int32,
                            device=dev, generator=gen)
        prev = H.hist_kernel(bins, nd, g, h, n_prev, N_BINS, kg, kh)
        def fused():
            return H.fused_round_kernel(bins, nd, feat, thr, g, h, prev,
                                        n_prev, N_BINS, kg, kh, True)

        out["fused_round_ms"][str(n_prev)] = time_ms(torch, fused, reps)
        if profile and n_prev == 1:
            out["fused_round_1_kernels_us"] = device_times(torch, fused,
                                                           reps)
    print(json.dumps(out), flush=True)


def run_ab(base, rows, reps, profile=False):
    runs = []
    for root in (base, ROOT, ROOT, base):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--rows", str(rows), "--reps", str(reps)]
            + (["--profile"] if profile else []),
            check=True, capture_output=True, text=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))

    def flat(r):
        return {"hist": r["hist_ms"], **{f"fused_round_{k}": v for k, v in
                                         r["fused_round_ms"].items()}}

    b = [flat(runs[0]), flat(runs[3])]
    c = [flat(runs[1]), flat(runs[2])]
    print(json.dumps({"ratio_this_over_base": {
        k: (c[0][k] + c[1][k]) / (b[0][k] + b[1][k]) for k in b[0]}}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--ab", metavar="BASE_DIR")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time (torch.profiler) "
                         "in hist and in fused_round at n_prev 1")
    args = ap.parse_args()
    if args.ab:
        run_ab(os.path.abspath(args.ab), args.rows, args.reps, args.profile)
    else:
        run_one(os.path.abspath(args.root), args.rows, args.reps,
                args.profile)


if __name__ == "__main__":
    main()
