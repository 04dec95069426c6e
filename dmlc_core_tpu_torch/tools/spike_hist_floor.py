#!/usr/bin/env python3
"""The histogram floor of the shallow levels, as one-hot matrix products on
the tensor cores: slope-timed variants that attribute the cost.

    python3 -m dmlc_core_tpu_torch.tools.spike_hist_floor
    SPIKE_ROWS=2000000 python3 -m dmlc_core_tpu_torch.tools.spike_hist_floor

The counterpart of ``scripts/spike_hist_floor.py``.  A level's histogram
can be built as the product of two one-hot matrices per feature and row
tile — ``[A, T]`` (the row's node and the high part of its bin, scaled by
its g or h) times ``[T, lo]`` (the low part of its bin), ``bin = hi·lo +
lo_part`` — which puts the work on the tensor cores; the port's own
histogram (``ops.histogram``, ``prod`` below) uses integer atomics
instead.  The variants (:data:`VARIANTS`, one CUDA kernel templated on
them, ``ops/csrc/hist_floor.cu``) separate the one-hot construction from
the product and from the accumulation of the output:

* ``shipped`` — per tile and feature, the ``[A, lo]`` product (a warp
  per feature);
* ``grpacc`` — the same products, a warp keeping the accumulators of a
  group of 8 features (its row loads shared by the 8), written at once;
* ``nodot`` — the construction only, summed instead of multiplied;
* ``noconstr`` — the product of one fixed pair of one-hots per tile;
* ``pack4`` / ``pack8`` — S features in one product ``[S·A, T]·[T, S·lo]``
  whose off-diagonal blocks are computed and thrown away.

Each pass is timed by its slope: CUDA events around N back-to-back passes
at N = 4 and N = 24, ``(t24 − t4) / 20``, median of 3, so the launch
overhead cancels.  ``main`` prints one JSON line per variant and then
``{"nb{n}_{variant}_ms": ...}`` for n_build 1 and 2 at ``SPIKE_ROWS``
(10M) rows of ``SPIKE_FEATURES`` (28), timed on their first multiple of
8 features (24), with the card's name and power limit.  It runs on the
card; ``--device cpu`` rehearses the control flow with the plain versions
(host-clock times, no device metric).

:func:`kernel_variant` is the wrapper (a CUDA tensor launches the kernel,
a CPU tensor runs :func:`kernel_variant_plain`, the plain PyTorch version
of the same function).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal
from dmlc_core_tpu_torch.ops.histogram import (_TILE_ROWS, _lo_factor,
                                               build_histogram, hist_scales)
from dmlc_core_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                              resolve_device)

__all__ = ["VARIANTS", "kernel_variant", "kernel_variant_plain",
           "tile_runs", "main"]

ROWS = int(os.environ.get("SPIKE_ROWS", 10_000_000))
FEATS = int(os.environ.get("SPIKE_FEATURES", 28))
BINS = 256
#: the kernel's variants, in ``hist_floor.cu``'s order
VARIANTS = ("shipped", "grpacc", "nodot", "noconstr", "pack4", "pack8")
#: features per group of the kernel (and of the JAX kernel's loop)
GROUP = 8
#: blocks of the kernel the run plan aims at an SM: more than fit at once
#: (one warpgroup and 38-60 KB of shared memory each: 3 to 6), as shorter
#: runs even out the SMs' work (8 against 4: 0.94x / 0.88x the time of
#: ``shipped`` at n_build 1 / 2 on an H100; PERF.md)
BLOCKS_PER_SM = 8
#: passes per timing of the slope, and its repeats
SLOPE_N = (4, 24)
SLOPE_REPEATS = 3


def _prep(n_build: int, rows: int = ROWS, feats: int = FEATS,
          device=None):
    """The spike's inputs from seed 0, drawn as the JAX script draws them:
    bins ``[feats, rows]`` uint8 uniform over 256, node ids uniform in
    ``[0, 2·n_build)`` (half the rows fall outside the level and add
    nothing), g normal, h uniform in [0, 1)."""
    rng = np.random.default_rng(0)
    bins_t = rng.integers(0, BINS, size=(feats, rows), dtype=np.uint8)
    node = rng.integers(0, max(2 * n_build, 1), size=rows, dtype=np.int32)
    g = rng.normal(size=rows).astype(np.float32)
    h = rng.random(rows).astype(np.float32)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a).to(dev) for a in (bins_t, node, g, h))


def _shape(bins_t, n_build, tile_rows, lo) -> Tuple[int, int, int, int]:
    """``(lo, hi, A, n_tiles)`` of one call, with the JAX kernel's
    limits: features in groups of 8, whole tiles only (``n // T``)."""
    lo = _lo_factor(n_build, BINS) if lo is None else lo
    hi = -(-BINS // lo)
    F, n = bins_t.shape
    CHECK(F % GROUP == 0 and F > 0,
          f"features must be a positive multiple of {GROUP}, got {F}")
    CHECK(tile_rows > 0 and n >= tile_rows,
          f"need at least one whole tile of {tile_rows} rows, got {n}")
    return lo, hi, 2 * n_build * hi, n // tile_rows


def tile_runs(n_tiles: int, n_groups: int, sms: int) -> int:
    """Tiles a block of the kernel adds in order, its run: the block
    keeps its sums in registers over the run and leaves one partial, and
    a second launch adds the runs in order.  The shortest run whose
    ``ceil(n_tiles / run)`` runs, times ``n_groups`` feature groups, are
    at most :data:`BLOCKS_PER_SM` blocks for each of ``sms`` SMs."""
    CHECK(n_tiles > 0 and n_groups > 0 and sms > 0,
          f"bad run plan inputs ({n_tiles}, {n_groups}, {sms})")
    runs = max(1, sms * BLOCKS_PER_SM // n_groups)
    return -(-n_tiles // min(n_tiles, runs))


def kernel_variant_plain(bins_t: torch.Tensor, node: torch.Tensor,
                         g: torch.Tensor, h: torch.Tensor, n_build: int,
                         variant: str, *, tile_rows: int = _TILE_ROWS,
                         lo: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`kernel_variant`: ``[F, A, lo]``
    f32, ``A = 2·n_build·hi``, row ``plane·nh + node·hi + bin//lo``
    (``nh = n_build·hi``, the g plane first), column ``bin % lo``.

    Per tile of ``tile_rows`` rows (rows past the last whole tile are not
    read) and feature, an f32 sum of the rows' bf16-rounded g or h, then
    the tiles added in order.  ``shipped``, ``grpacc``, ``pack4`` and
    ``pack8`` are that histogram; ``nodot`` is ``bf16(bf16(lhs row sum) +
    bf16(rhs row sum))`` per tile over every column (the lhs row sums in
    f32 rounded once; the rhs row ``r`` counts the tile's rows whose
    ``bin % lo == r``, all rows); ``noconstr`` fills column 0 of rows
    ``plane·nh + node·hi`` with the tile's sums per node, the same block
    for every feature.  Rows whose node is not in ``[0, n_build)`` add
    nothing."""
    CHECK(variant in VARIANTS, f"unknown variant {variant!r}")
    lo, hi, A, n_tiles = _shape(bins_t, n_build, tile_rows, lo)
    F = bins_t.shape[0]
    nh = n_build * hi
    rows = n_tiles * tile_rows
    dev = bins_t.device
    f32 = torch.float32
    nd = node[:rows].to(torch.int64)
    keep = torch.nonzero((nd >= 0) & (nd < n_build)).squeeze(1)
    gb = g[:rows].to(torch.bfloat16).to(f32)[keep]
    hb = h[:rows].to(torch.bfloat16).to(f32)[keep]
    tile = keep // tile_rows
    base = nd[keep] * hi
    if variant == "noconstr":
        part = torch.zeros(n_tiles * A, dtype=f32, device=dev)
        part.index_add_(0, tile * A + base, gb)
        part.index_add_(0, tile * A + nh + base, hb)
        d = torch.zeros(n_tiles, F, A, lo, dtype=f32, device=dev)
        d[..., 0] = part.view(n_tiles, 1, A)
    elif variant == "nodot":
        CHECK(A <= lo, f"nodot needs A <= lo, got A={A}, lo={lo}")
        lhs = torch.zeros(n_tiles * F * A, dtype=f32, device=dev)
        rhs = torch.zeros(n_tiles * F * lo, dtype=f32, device=dev)
        every = torch.arange(rows, device=dev) // tile_rows
        ones = torch.ones(rows, dtype=f32, device=dev)
        for f in range(F):
            b = bins_t[f, :rows].to(torch.int64)
            row = (tile * F + f) * A + base + b[keep] // lo
            lhs.index_add_(0, row, gb)
            lhs.index_add_(0, row + nh, hb)
            rhs.index_add_(0, (every * F + f) * lo + b % lo, ones)
        s = (lhs.view(n_tiles, F, A).to(torch.bfloat16)
             + rhs.view(n_tiles, F, lo)[..., :A].to(torch.bfloat16))
        d = s.to(f32)[..., None].expand(n_tiles, F, A, lo)
    else:
        part = torch.zeros(n_tiles * F * A * lo, dtype=f32, device=dev)
        for f in range(F):
            b = bins_t[f, :rows].to(torch.int64)[keep]
            cell = ((tile * F + f) * A + base + b // lo) * lo + b % lo
            part.index_add_(0, cell, gb)
            part.index_add_(0, cell + nh * lo, hb)
        d = part.view(n_tiles, F, A, lo)
    out = torch.zeros(F, A, lo, dtype=f32, device=dev)
    for i in range(n_tiles):                 # the TPU grid's order
        out += d[i]
    return out


def kernel_variant(bins_t: torch.Tensor, node: torch.Tensor,
                   g: torch.Tensor, h: torch.Tensor, n_build: int,
                   variant: str, *, tile_rows: int = _TILE_ROWS,
                   lo: Optional[int] = None) -> torch.Tensor:
    """The one-hot product histogram ``[F, A, lo]`` of :func:`kernel_variant_
    plain` by the CUDA kernel of ``variant`` (two launches: a block per
    run of consecutive tiles (:func:`tile_runs`) and group of 8 features
    sums its tiles in order into one partial, then the runs are added in
    order) on a CUDA tensor; a CPU tensor runs the plain version.  ``bins_t`` is
    ``[F, n]`` uint8 with unit row-element stride (a slice of the first
    features of a wider matrix is fine).  The kernel takes ``lo = 32``
    and n_build 1 or 2 (``A`` 16 or 32).  Counts its launches per variant
    in ``kernel_variant.launches``."""
    CHECK(variant in VARIANTS, f"unknown variant {variant!r}")
    if not bins_t.is_cuda:
        CHECK(bins_t.device.type == "cpu", "unsupported device")
        return kernel_variant_plain(bins_t, node, g, h, n_build, variant,
                                    tile_rows=tile_rows, lo=lo)
    lo, hi, A, n_tiles = _shape(bins_t, n_build, tile_rows, lo)
    F, n = bins_t.shape
    CHECK(lo == 32 and A in (16, 32),
          f"the kernel takes lo 32 and A 16 or 32, got lo={lo}, A={A}")
    CHECK(tile_rows % 16 == 0, "tile_rows must be a multiple of 16")
    CHECK(bins_t.dtype == torch.uint8 and bins_t.stride(1) == 1
          and bins_t.stride(0) % 4 == 0 and bins_t.data_ptr() % 4 == 0,
          "bins_t must be uint8 [F, n] with unit element stride, 4-byte "
          "aligned rows")
    for name, t, dt in (("node", node, torch.int32), ("g", g, torch.float32),
                        ("h", h, torch.float32)):
        CHECK(t.device == bins_t.device and t.dtype == dt
              and t.shape == (n,) and t.is_contiguous()
              and t.data_ptr() % 16 == 0,
              f"{name} must be a contiguous 16-byte aligned [{n}] {dt} "
              f"tensor on {bins_t.device}")
    from dmlc_core_tpu_torch.ops._build import load_library

    sms = torch.cuda.get_device_properties(bins_t.device).multi_processor_count
    per_run = tile_runs(n_tiles, F // GROUP, sms)
    partial = torch.empty(-(-n_tiles // per_run), F, A, lo,
                          dtype=torch.float32, device=bins_t.device)
    out = torch.empty(F, A, lo, dtype=torch.float32, device=bins_t.device)
    rc = load_library("hist_floor").dmlc_hist_floor(
        bins_t.data_ptr(), bins_t.stride(0), node.data_ptr(), g.data_ptr(),
        h.data_ptr(), n_tiles, tile_rows, F, n_build, hi,
        VARIANTS.index(variant), per_run, partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(bins_t.device).cuda_stream)
    if rc != 0:
        log_fatal(f"dmlc_hist_floor ({variant}): CUDA launch failed with "
                  f"cudaError {rc}")
    kernel_variant.launches[variant] += 1
    return out


kernel_variant.launches = {v: 0 for v in VARIANTS}


def factored(hist: torch.Tensor, lo: int) -> torch.Tensor:
    """A ``[2, N, F, B]`` histogram (:func:`~dmlc_core_tpu_torch.ops.
    histogram.build_histogram`) in the product's ``[F, 2·N·hi, lo]``
    layout."""
    P, N, F, B = hist.shape
    return (hist.reshape(P, N, F, B // lo, lo).permute(2, 0, 1, 3, 4)
            .reshape(F, P * N * (B // lo), lo))


def one_pass(bins_t, node, g, h, n_build, variant, scales=None):
    """One level pass: ``prod`` is the port's histogram
    (:func:`~dmlc_core_tpu_torch.ops.histogram.build_histogram`, B1's
    kernel on a CUDA tensor) at the fixed-point ``scales``; any other
    name a :func:`kernel_variant`."""
    if variant == "prod":
        return build_histogram(bins_t, node, g, h, n_build, BINS,
                               scales=scales)
    return kernel_variant(bins_t, node, g, h, n_build, variant)


def _run_level(bins_t, node, g, h, n_build, variant) -> float:
    """Seconds of one pass of ``variant`` over ``bins_t``'s first multiple
    of 8 features, by the slope of N back-to-back passes (CUDA events on
    the card, the host clock on the CPU).  The JAX script chains its
    passes in one program with a carry perturbing the node ids, so that
    XLA cannot hoist the pass out of the chain; eager launches need no
    such device, each pass runs."""
    fp = bins_t.shape[0] - bins_t.shape[0] % GROUP
    bins_fp = bins_t[:fp]
    scales = hist_scales(g, h) if variant == "prod" else None
    cuda = bins_t.is_cuda

    def timed(reps: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                one_pass(bins_fp, node, g, h, n_build, variant, scales)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            one_pass(bins_fp, node, g, h, n_build, variant, scales)
        return time.perf_counter() - t0

    timed(2)                       # first use: build and load
    timed(12)
    small, big = SLOPE_N
    slopes = []
    for _ in range(SLOPE_REPEATS):
        t_small, t_big = timed(small), timed(big)
        slopes.append((t_big - t_small) / (big - small))
    return statistics.median(slopes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (a rehearsal with the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    out = {"rows": ROWS, "features": FEATS, "tile": _TILE_ROWS,
           "platform": "gpu" if cuda else "cpu",
           "timer": "cuda_events" if cuda else "host_clock"}
    if cuda:
        out["device_kind"] = torch.cuda.get_device_name(dev)
        out["nvidia_smi"] = gpu_name_and_power_limit()
    for n_build in (1, 2):               # the L0-L2 floor levels
        bins_t, node, g, h = _prep(n_build, device=dev)
        for variant in ("prod",) + VARIANTS:
            ms = _run_level(bins_t, node, g, h, n_build, variant) * 1e3
            out[f"nb{n_build}_{variant}_ms"] = ms
            print(json.dumps({f"nb{n_build}_{variant}_ms": ms}), flush=True)
        del bins_t, node, g, h
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
