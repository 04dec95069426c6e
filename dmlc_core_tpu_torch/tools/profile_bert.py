#!/usr/bin/env python3
"""Where a BERT training step's device time goes.

    python3 dmlc_core_tpu_torch/tools/profile_bert.py [--steps N]

Trains ``BERT()`` (BERT-base defaults, ``init_params(0)``) on the card on
the bench's batch (8 × 512, seed 0, labels = tokens, mask of ones): a few
warm-up steps, then ``--steps`` steps under ``torch.profiler``.  Prints one
JSON line with the card's name and power limit, the host-clock time per
step, each CUDA kernel group's device time per step (the three flash
kernels, the matrix products — kernels named ``*gemm*`` — and the rest),
the busiest other kernels, and the device's idle share: one minus the
summed kernel time over the window's wall time (one stream, so kernels
do not overlap).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH, SEQ, SEED = 8, 512, 0
GROUPS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def group_of(name: str) -> str:
    for g in GROUPS:
        if g in name:
            return g
    return "gemm" if "gemm" in name.lower() else "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dmlc_core_tpu_torch.models import BERT
    from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

    if not torch.cuda.is_available():
        print("profile_bert: no CUDA GPU available", file=sys.stderr)
        return 1
    model = BERT(device="cuda")
    model.init_params(SEED)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, model.param.vocab_size, size=(BATCH, SEQ))
    batch = (tokens, tokens.copy(), np.ones(tokens.shape, np.float32))
    for _ in range(args.warmup):
        model.train_step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model.train_step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {g: 0.0 for g in (*GROUPS, "gemm", "other")}
    others = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        g = group_of(evt.key)
        groups[g] += us
        if g == "other":
            others[evt.key[:80]] = us / args.steps / 1e3
    busy = sum(groups.values()) / 1e6
    print(json.dumps({
        "nvidia_smi": gpu_name_and_power_limit(), "batch": BATCH,
        "seq": SEQ, "steps": args.steps,
        "wall_ms_per_step": wall / args.steps * 1e3,
        "device_ms_per_step": {g: v / args.steps / 1e3
                               for g, v in groups.items()},
        "busiest_other_ms_per_step": dict(sorted(
            others.items(), key=lambda kv: -kv[1])[:12]),
        "device_idle_share": 1.0 - busy / wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
