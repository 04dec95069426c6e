#!/usr/bin/env python3
"""Where a boosting round's device time goes.

    python3 dmlc_core_tpu_torch/tools/profile_gbt.py [--rounds N]
        [--depthwise | --fused-descend] [--root DIR]

Fits ``HistGBT(max_depth=6, n_bins=256)`` on the card over
``chip_smoke.py``'s HIGGS-like 10M × 28 rows (seed 7, binned on the card)
as configuration 1 (the bench's levers: lossguide, 16 leaves, int4 packing
and feature bundling requested; ``--depthwise``: no levers;
``--fused-descend``: depth-wise with the data-parallel path's levers on
one card, ``DMLC_HIST_BLOCKS=8`` and ``DMLC_TPU_FUSED_DESCEND=1``, so
every level below the root is one fused descend, B3): one fit of
``--rounds`` trees after ``--warmup`` discarded rounds, then the same fit
again under ``torch.profiler``.  Prints one JSON line with the card's name
and power limit, the host-clock time per round, each CUDA kernel group's
device time per round (the histogram accumulation, the descend, the
epilogue, the fused descend, the rest) with its launches per round, the
busiest other
kernels, and the device's idle share: one minus the summed kernel time
over the fit's wall time (one stream, so kernels do not overlap).
``--root`` profiles the package of another checkout on the same rows.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# "fused_descend_kernel" before "descend_kernel", its substring
GROUPS = ("hist_accum_kernel", "fused_descend_kernel", "descend_kernel",
          "hist_epilogue_kernel")


def group_of(name: str) -> str:
    # the fused descend is the accumulation kernel with a descend prologue
    if re.search(r"hist_accum_kernel<(true|false), [12]>", name):
        return "fused_descend_kernel"
    for g in GROUPS:
        if g in name:
            return g
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--depthwise", action="store_true")
    mode.add_argument("--fused-descend", action="store_true")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    # this checkout's rows and levers, whichever package is profiled
    sys.path.insert(0, ROOT)
    import chip_smoke as c

    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import dmlc_core_tpu_torch
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

    if not torch.cuda.is_available():
        print("profile_gbt: no CUDA GPU available", file=sys.stderr)
        return 1
    X, y = c.higgs_like(np, c.ROWS, c.FEATURES, 7)
    env = (c.DP_BLOCKS if args.fused_descend
           else {} if args.depthwise else c.BENCH_LEVERS)
    with c.levers(env):
        model = HistGBT(n_trees=args.rounds, max_depth=c.MAX_DEPTH,
                        n_bins=c.N_BINS, device="cuda")
        dd = model.make_device_data(X, y)
        del X, y
        model.fit_device(dd, warmup_rounds=args.warmup)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.fit_device(dd)
            torch.cuda.synchronize()
    wall = model.last_fit_seconds
    groups = {g: 0.0 for g in (*GROUPS, "other")}
    launches = {g: 0 for g in groups}
    others = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        g = group_of(evt.key)
        groups[g] += us
        launches[g] += evt.count
        if g == "other":
            others[evt.key[:80]] = us / args.rounds / 1e3
    busy = sum(groups.values()) / 1e6
    print(json.dumps({
        "nvidia_smi": gpu_name_and_power_limit(),
        "package": os.path.dirname(dmlc_core_tpu_torch.__file__),
        "config": ("fused_descend" if args.fused_descend
                   else "depthwise" if args.depthwise else "1"),
        "levers": env, "rows": c.ROWS, "features": c.FEATURES,
        "rounds": args.rounds,
        "wall_ms_per_round": wall / args.rounds * 1e3,
        "device_ms_per_round": {g: v / args.rounds / 1e3
                                for g, v in groups.items()},
        "device_ms_per_round_total": busy / args.rounds * 1e3,
        "launches_per_round": {g: v / args.rounds
                               for g, v in launches.items()},
        "busiest_other_ms_per_round": dict(sorted(
            others.items(), key=lambda kv: -kv[1])[:12]),
        "device_idle_share": 1.0 - busy / wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
