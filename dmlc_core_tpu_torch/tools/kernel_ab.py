#!/usr/bin/env python3
"""Time the histogram kernels of one checkout of the port, or A/B two.

    python3 dmlc_core_tpu_torch/tools/kernel_ab.py [--root DIR]
    python3 dmlc_core_tpu_torch/tools/kernel_ab.py --ab BASE_DIR

One run times ``hist_kernel`` at the root and ``fused_round_kernel`` at
``N_PREV`` parents on random ``[28, 10M]`` bins with 256 bins and no bin layout
(the flagship's shapes), through the package found under ``--root`` (default:
the checkout holding this file), with CUDA events (median of ``--reps`` after
one warm-up) and by device time (every CUDA kernel of a call, summed from a
``torch.profiler`` trace), and prints one JSON line with the card's name and
power limit.  ``--layouts`` adds the layout modes by device time:
``hist_kernel`` at the root and ``fused_round_kernel`` at ``LAYOUT_N_PREV`` on
the physical matrices of configurations 2a and 2b (``chip_smoke.py``'s
covtype-schema rows and levers).  ``--ab`` runs BASE_DIR, this checkout, this
checkout, BASE_DIR, each in its own process on the same card, then prints the
time of each kernel in this checkout over its time in BASE_DIR (the two runs of
each averaged).  ``--profile`` adds each CUDA kernel's mean device time inside
``hist`` and ``fused_round`` at n_prev 1, from a ``torch.profiler`` trace.
``--descend`` adds B3, ``fused_descend_kernel`` at ``DESCEND_N_PREV`` parents
(per-node tables), beside the two-kernel chain it replaces (``descend_kernel``,
then ``hist_kernel`` over left children), both by device time and each checked
equal to the other.  ``--floor`` adds B5, the six one-hot
product variants of ``tools/spike_hist_floor.py`` at n_build 1 and 2 on the
spike's inputs (10M rows, the first 24 features), by device time.
``--no-rounds`` leaves out ``hist`` and ``fused_round``.  ``--attention``
times the three flash-attention kernels instead
(``flash_fwd_kernel``, ``flash_bwd_dkv_kernel``, ``flash_bwd_dq_kernel``) at
BERT-base's ``[8, 512, 12, 64]``, non-causal and causal, by device time from a
profiler trace, and by CUDA events over ``ATTN_INNER`` calls back to back.
Only the API both sides share is used.
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
#: n_prev of B3's levels: a depth-6 tree's, and three deeper ones
DESCEND_N_PREV = (1, 2, 4, 8, 16, 32, 64, 2048)
#: n_prev of the layout-mode levels (lossguide's, and depth-wise ones)
LAYOUT_N_PREV = (1, 4, 16)
SEED = 0
ATTN_SHAPE = (8, 512, 12, 64)
ATTN_INNER = 10


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


def run_attention(root, reps):
    """Device and CUDA-event ms of the three flash kernels of ``root``."""
    c = this_chip_smoke()
    sys.path.insert(0, root)
    import torch

    from dmlc_core_tpu_torch.ops import attention as A
    from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

    if not os.path.abspath(A.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {A.__file__}, not from {root}")
    B, S, H, D = ATTN_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    qkv = torch.randn((3, B, S, H, D), device=dev,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(0)
    do = torch.randn((B, S, H, D), device=dev,
                     generator=gen).to(torch.bfloat16)
    scale = D ** -0.5
    out = {"root": root, "nvidia_smi": gpu_name_and_power_limit(),
           "B_S_H_D": list(ATTN_SHAPE), "attention": {}}
    for causal in (False, True):
        o, lse = A.flash_fwd_kernel(q, k, v, causal, scale)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        fns = {"flash_fwd": lambda: A.flash_fwd_kernel(q, k, v, causal,
                                                       scale),
               "flash_bwd_dkv": lambda: A.flash_bwd_dkv_kernel(
                   q, k, v, do, lse, di, causal, scale),
               "flash_bwd_dq": lambda: A.flash_bwd_dq_kernel(
                   q, k, v, do, lse, di, causal, scale)}
        for name, fn in fns.items():
            def inner(fn=fn):
                for _ in range(ATTN_INNER):
                    fn()

            key = name + ("_causal" if causal else "")
            out["attention"][key] = {
                "device_ms": c.device_ms(torch, fn, reps),
                "ms": time_ms(torch, inner, reps) / ATTN_INNER}
    print(json.dumps(out), flush=True)


def this_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its data, levers and
    ``device_ms``), imported before ``root`` goes on the path, so that
    both sides of an A/B use the same inputs and the same measurement."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def run_one(root, rows, reps, profile=False, layouts=False, rounds=True,
            descend=False, floor=False):
    c = this_chip_smoke()
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

    def hist():
        return H.hist_kernel(bins, root_node, g, h, 1, N_BINS, kg, kh)

    out = {"root": root, "nvidia_smi": gpu_name_and_power_limit(),
           "rows": rows, "features": FEATURES, "n_bins": N_BINS,
           "hist_ms": None, "device_ms": {}, "fused_round_ms": {}}
    if rounds:
        out["hist_ms"] = time_ms(torch, hist, reps)
        out["device_ms"]["hist"] = c.device_ms(torch, hist, reps)
    if profile:
        out["hist_kernels_us"] = device_times(torch, hist, reps)
    for n_prev in N_PREV if rounds else ():
        name = f"fused_round_{n_prev}"
        fused = level(torch, H, bins, g, h, gen, n_prev, N_BINS, kg, kh)
        out["fused_round_ms"][str(n_prev)] = time_ms(torch, fused, reps)
        out["device_ms"][name] = c.device_ms(torch, fused, reps)
        if profile and n_prev == 1:
            out["fused_round_1_kernels_us"] = device_times(torch, fused,
                                                           reps)
    if descend:
        out["descend_equal"] = {}
        for n_prev in DESCEND_N_PREV:
            fns, equal = descend_level(torch, H, bins, g, h, gen, n_prev, kg,
                                       kh)
            out["descend_equal"][str(n_prev)] = equal
            for name, fn in fns.items():
                out["device_ms"][f"{name}_{n_prev}"] = c.device_ms(torch, fn,
                                                                   reps)
    if layouts:
        del bins
        for cfg, lay, phys in layout_matrices(c):
            lg = torch.Generator(device=dev)
            lg.manual_seed(SEED)
            n = phys.shape[1]
            lp = torch.sigmoid(0.5 * torch.randn(n, device=dev,
                                                 generator=lg))
            ly = (torch.rand(n, device=dev, generator=lg) < lp).float()
            gl, hl = lp - ly, lp * (1 - lp)
            kgl, khl = H.hist_scales(gl, hl)
            node0 = torch.zeros(n, dtype=torch.int32, device=dev)
            Bs = lay.sync_bins
            out["device_ms"][f"hist_layout_{cfg}"] = c.device_ms(
                torch, lambda: H.hist_kernel(phys, node0, gl, hl, 1, Bs, kgl,
                                             khl, lay), reps)
            for n_prev in LAYOUT_N_PREV:
                fused = level(torch, H, phys, gl, hl, lg, n_prev, Bs, kgl,
                              khl, lay, c)
                out["device_ms"][f"fused_round_layout_{cfg}_{n_prev}"] = \
                    c.device_ms(torch, fused, reps)
    if floor:
        bins = g = h = None
        from dmlc_core_tpu_torch.tools import spike_hist_floor as S

        for n_build in (1, 2):
            fb, node, fg, fh = S._prep(n_build, rows, FEATURES, "cuda")
            fb = fb[:FEATURES - FEATURES % S.GROUP]
            for v in S.VARIANTS:
                out["device_ms"][f"hist_floor_{v}_nb{n_build}"] = c.device_ms(
                    torch, lambda: S.kernel_variant(fb, node, fg, fh, n_build,
                                                    v), reps)
            del fb, node, fg, fh
    print(json.dumps(out), flush=True)


def descend_level(torch, H, bins, g, h, gen, n_prev, kg, kh):
    """B3 at one level of ``n_prev`` random parents (per-node tables):
    ``({name: fn}, equal)`` with ``fused_descend`` and ``descend_chain``
    (``descend_kernel`` then ``hist_kernel`` over left children);
    ``equal``: the two give the same bytes."""
    F, rows = bins.shape
    dev = bins.device
    nd = torch.randint(0, n_prev, (rows,), dtype=torch.int32, device=dev,
                       generator=gen)
    feat = torch.randint(0, F, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)
    thr = torch.randint(0, N_BINS - 1, (n_prev,), dtype=torch.int32,
                        device=dev, generator=gen)

    def chain():
        # the wrapper, so that either checkout's C signature is met
        return H.fused_descend_histogram(bins, nd, feat, thr, g, h, n_prev,
                                         N_BINS, fuse=False, by_node=True,
                                         scales=(kg, kh))

    def fused():
        return H.fused_descend_kernel(bins, nd, feat, thr, g, h, n_prev,
                                      N_BINS, kg, kh, True)

    fns = {"fused_descend": fused, "descend_chain": chain}
    want = chain()
    equal = all(torch.equal(a, b) for name, fn in fns.items()
                for a, b in zip(fn(), want))
    torch.cuda.synchronize()
    return fns, equal


def level(torch, H, bins, g, h, gen, n_prev, n_bins, kg, kh, layout=None,
          c=None):
    """A ``fused_round_kernel`` call at one level of ``n_prev`` random
    parents (per-node split tables; under a layout the thresholds of
    ``chip_smoke.py``'s (``c``) ``layout_thresholds``, which take both
    sides of every decoded feature)."""
    rows = bins.shape[1]
    dev = bins.device
    F = bins.shape[0] if layout is None else layout.n_features
    nd = torch.randint(0, n_prev, (rows,), dtype=torch.int32, device=dev,
                       generator=gen)
    feat = torch.randint(0, F, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)
    if layout is None:
        thr = torch.randint(0, n_bins - 1, (n_prev,), dtype=torch.int32,
                            device=dev, generator=gen)
    else:
        thr = torch.from_numpy(c.layout_thresholds(
            layout, feat.cpu().numpy(), n_prev)).to(dev)
    prev = H.hist_kernel(bins, nd, g, h, n_prev, n_bins, kg, kh, layout)

    def fused():
        return H.fused_round_kernel(bins, nd, feat, thr, g, h, prev, n_prev,
                                    n_bins, kg, kh, True, layout)

    return fused


def layout_matrices(c):
    """``(config, layout, physical matrix on the card)`` of configurations
    2a (pack + bundle) and 2b (pack only) on ``chip_smoke.py``'s (``c``)
    covtype-schema rows, as the model derives them."""
    import numpy as np

    from dmlc_core_tpu_torch import HistGBT

    X, y = c.covtype_like(np, c.COVTYPE_ROWS, c.COVTYPE_SEED)
    for cfg, env in (("2a", c.BENCH_LEVERS), ("2b", c.PACK_ONLY)):
        with c.levers(env):
            dd = HistGBT(max_depth=6, n_bins=N_BINS,
                         device="cuda").make_device_data(X, y)
        yield cfg, dd["layout"], dd["bins_t"]


def run_ab(base, rows, reps, profile=False, attention=False,
           layouts=False, rounds=True, descend=False, floor=False):
    runs = []
    for root in (base, ROOT, ROOT, base):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--rows", str(rows), "--reps", str(reps)]
            + (["--profile"] if profile else [])
            + (["--attention"] if attention else [])
            + (["--layouts"] if layouts else [])
            + ([] if rounds else ["--no-rounds"])
            + (["--descend"] if descend else [])
            + (["--floor"] if floor else []),
            check=True, capture_output=True, text=True, timeout=900)
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))

    def flat(r):
        if attention:
            return {f"{k}_{m}": v[m] for k, v in r["attention"].items()
                    for m in ("device_ms", "ms")}
        return {**({"hist": r["hist_ms"]} if r["hist_ms"] else {}),
                **{f"fused_round_{k}": v for k, v in
                   r["fused_round_ms"].items()},
                **{f"{k}_device": v for k, v in r["device_ms"].items()}}

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
    ap.add_argument("--attention", action="store_true",
                    help="time the flash-attention kernels instead")
    ap.add_argument("--layouts", action="store_true",
                    help="also the layout modes on configurations 2a "
                         "and 2b (covtype-schema rows), by device time")
    ap.add_argument("--descend", action="store_true",
                    help="also B3 (fused_descend) and its two-kernel "
                         "chain, by device time")
    ap.add_argument("--floor", action="store_true",
                    help="also B5's six one-hot product variants at "
                         "n_build 1 and 2, by device time")
    ap.add_argument("--no-rounds", dest="rounds", action="store_false",
                    help="leave out hist and fused_round")
    args = ap.parse_args()
    if args.ab:
        run_ab(os.path.abspath(args.ab), args.rows, args.reps, args.profile,
               args.attention, args.layouts, args.rounds, args.descend,
               args.floor)
    elif args.attention:
        run_attention(os.path.abspath(args.root), args.reps)
    else:
        run_one(os.path.abspath(args.root), args.rows, args.reps,
                args.profile, args.layouts, args.rounds, args.descend,
                args.floor)


if __name__ == "__main__":
    main()
