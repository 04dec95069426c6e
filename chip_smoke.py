#!/usr/bin/env python3
"""Drive the PyTorch port (``dmlc_core_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

The quickest proof that the port starts on the GPU and that its CUDA
kernels are right.  Phases, each printing one JSON line; any failure raises
and the script exits non-zero without the final ``ok`` line:

1. device — the card's name and power limit, torch/CUDA versions, and the
   build of every kernel from ``dmlc_core_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together); then the data, made from
   seeds: HIGGS-like 10M × 28 (bench.py's rule, seed 7) and covtype-schema
   581,012 × 54 (:func:`covtype_like`); and the device route's binning
   of ±inf columns, whose cuts hold NaN (:func:`check_inf_binning`);
2. kernels — each kernel at the flagship's shapes (10M rows, 28 features,
   256 bins: ``hist`` at the root, ``fused_round`` and ``fused_descend``
   at n_prev 1..16) against its plain PyTorch version on the same inputs
   (bit-identical), twice on the same inputs (identical bytes), timed with
   CUDA events (median of ``REPS``) and as device time from a
   ``torch.profiler`` trace, beside its bound and, where one PyTorch call
   computes the same function, that call (``fused_descend`` also beside
   the unfused chain it replaces, ``descend_kernel`` then ``hist`` over
   left children, by CUDA events and device time);
3. kernels_layout — the same for the LAYOUT MODES (``hist_layout``,
   ``fused_round_layout`` at n_prev 1, 4, 16) on the physical matrices of
   configurations 2a (12 rows: two bundles) and 2b (34 rows: 22 int4
   pairs);
4. main — the depth-wise ``HistGBT(n_trees=5, max_depth=6, n_bins=256)``
   fit on the HIGGS-like data: launch counts set to 0 before and read
   after the fit, train logloss falling every round, ``predict`` on
   held-out rows, ``save_model`` → ``load_model`` giving the same
   predictions, and the round's bin-matrix bound;
5. main_lossguide — configuration 1, the bench's levers
   (``DMLC_GROW_POLICY=lossguide``, ``DMLC_MAX_LEAVES=16``,
   ``DMLC_BIN_PACK=1``, ``DMLC_FEATURE_BUNDLE=1``) on the same data: no
   layout fires, exactly 1 ``hist`` + 15 ``fused_round`` per tree, the
   checks of phase 4;
6. levers — configurations 2a (the bench's levers) and 2b (pack only) on
   the covtype-schema data, the checks of phase 4 with the layout modes'
   launches, against the lossguide fit with both levers off: 2b's model
   file byte-identical, 2a's split structure identical;
7. cross-device — depth-wise, 1, 2a and 2b on 100k-row slices, on the GPU
   and on the CPU (plain versions): every tree bit-identical;
8. data_parallel — the data-parallel fit on the HIGGS-like rows: (a) a
   NCCL group of one on this card, ``DMLC_HIST_BLOCKS=8`` and
   ``DMLC_TPU_FUSED_DESCEND=1``: 5 ``fused_descend`` and no
   ``fused_round`` per tree, the model file of phase 4; (b) two ranks
   sharing this card under gloo (NCCL refuses two ranks on one GPU), 5M
   rows each, depth-wise and configuration 1 with
   ``DMLC_TPU_FUSED_DESCEND=1``: each rank's model file that of phase 4
   / 5; (c) the int8 sync (``DMLC_HIST_QUANT=1``) on the two ranks: the
   held-out accuracy floor of phase 4, its margins beside (b)'s exact
   ones.  The ranks are child processes with a time limit;
9. deep kernels — the checks of phases 2 and 3 for ``fused_round`` and
   ``fused_descend`` at the levels of deeper trees (n_prev 32, 64 and
   2048 on the flagship's shapes, 64 and 2048 under each covtype layout
   for ``fused_round``, up to ``max_depth=12``), where the histogram
   outgrows shared memory and the kernel adds straight into the global
   one;
10. attention_kernels — the three flash-attention kernels of
    ``csrc/attention.cu`` (forward, dK/dV, dQ) at BERT-base's shape
    (``[8, 512, 12, 64]`` bf16, q/k/v views of one QKV tensor as the model
    makes them), causal at the same shape, and at sequences that are no
    tile multiple and the other head dims: each against its plain version
    on the same inputs (``o`` within 2^-7 and dq/dk/dv within 2^-6 of the
    plain result's largest magnitude, ``lse`` within 1e-4), twice on the
    same inputs (identical bytes); at BERT-base's shape timed (10 calls
    back to back per CUDA-event pair, and as device time from a
    ``torch.profiler`` trace) beside its bound and
    ``F.scaled_dot_product_attention``'s time (the yardstick only: the
    port never calls it) — its forward, and its backward alone
    (``autograd.grad`` on a retained graph, the forward outside the
    timing), each also as device time from a ``torch.profiler`` trace;
11. bert — ``BERT()`` at BERT-base width on the card, the bench's batch
    (8 × 512, seed 0, labels = tokens, mask of ones): one step, then
    ``fit_chunked`` (10 warmup + 20 timed steps) with the launch counts
    set to 0 before and read after (12 of each kernel per step), a falling
    loss, steps/s, tokens/s, matmul TFLOP/s and peak device memory, then
    ``save_model`` → ``load_model`` giving the same weights, momentum and
    next loss; and a two-layer BERT (head dim 64) trained three steps on
    the card and on the CPU from one seed: losses within 2e-3, weights
    within 1e-3;
12. hist_floor — B5, the one-hot product histogram on the tensor cores
    (``tools/spike_hist_floor.py``, ``csrc/hist_floor.cu``): every variant
    at the spike's shapes (10M rows, the first 24 of 28 features, n_build
    1 and 2, tiles of 16384 rows) against its plain version on order-exact
    g/h (bit-identical; the product variants also equal the port's
    histogram, B1's kernel, in the factored layout) and on the spike's
    general g/h (within ``FLOOR_TOL``, ``nodot`` within ``NODOT_TOL``),
    twice on the same inputs (identical bytes), each timed as device time
    from a ``torch.profiler`` trace; then the spike's main path: each
    variant and ``prod`` slope-timed (``_run_level``) with the launch
    counts set to 0 before and read after, beside the bound, the plain
    version's time and ``index_add_``'s (B1's yardstick);
13. bench — ``python -m dmlc_core_tpu_torch.bench`` as a child process at
    its defaults (10M × 28, 100 rounds after 10 warmup rounds, the
    flagship's levers, host binning), with a time limit: its last line
    must be the final ``histgbt_rounds_per_sec_per_chip`` record of 100
    rounds, with kernel launches, and its headline fields are emitted;
14. the ``kernels`` line (launches summed over phases 4-6 and 8, phase
    11's for attention, phase 12's timing pass for the B5 variants), then
    the card's name and power limit, then the ``ok`` line.

The fit phases (4-8) run with ``DMLC_TPU_ROUNDS_PER_DISPATCH=1``: each
tree is its own chunk, fetched on its own, so ``last_tree_times`` stay
per tree and the steady rate can leave the first tree out.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the card every phase runs on
DEVICE = "cuda"

#: the flagship's shapes: rows of the kernel checks and of the fit
#: (HIGGS-like 10M × 28, 256 bins, depth 6)
ROWS = 10_000_000
FEATURES = 28
N_BINS = 256
MAX_DEPTH = 6
#: trees of the fit (≥ 2: the steady rate leaves the first tree out)
TREES = 5
#: CUDA-event timings per median (the plain versions take a third)
REPS = 10
#: seed of the kernel checks' inputs
SEED = 0
#: n_prev of the levels of trees deeper than the main path's (depth 7's
#: last level, the first level past shared memory, ``max_depth=12``'s last)
DEEP_N_PREV = (32, 64, 2048)
#: covtype's row count and schema (UCI Covertype / LIBSVM covtype.binary):
#: 10 integer columns, 4 one-hot wilderness columns at these counts, 40
#: one-hot soil columns
COVTYPE_ROWS = 581_012
COVTYPE_FEATURES = 54
WILDERNESS_COUNTS = (260_796, 29_884, 253_364, 36_968)
COVTYPE_SEED = 11
#: seed of the covtype-schema label's fixed soil effects
LABEL_SEED = 54
#: n_prev of the layout-mode fused_round checks: lossguide's expansion,
#: and depth-wise levels under a layout
LAYOUT_N_PREV = (1, 4, 16)
#: n_prev of the layout-mode checks past shared memory (the first level
#: past it, ``max_depth=12``'s last)
DEEP_LAYOUT_N_PREV = (64, 2048)
#: rows of the cross-device fits
CROSS_ROWS = 100_000
#: the bench's levers (bench.py's flagship) and the A/B variants
MAX_LEAVES = 16
LEVER_NAMES = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
               "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS",
               "DMLC_TPU_FUSED_DESCEND", "DMLC_HIST_QUANT",
               "DMLC_FUSED_ROUND")
LEVERS_OFF = {"DMLC_GROW_POLICY": "lossguide",
              "DMLC_MAX_LEAVES": str(MAX_LEAVES)}
PACK_ONLY = {**LEVERS_OFF, "DMLC_BIN_PACK": "1"}
BENCH_LEVERS = {**PACK_ONLY, "DMLC_FEATURE_BUNDLE": "1"}
#: the data-parallel phase's levers (the fused round is off on every
#: synced path): the fused descend on, and the deterministic blocks
FUSED_DESCEND = {"DMLC_TPU_FUSED_DESCEND": "1"}
DP_BLOCKS = {**FUSED_DESCEND, "DMLC_HIST_BLOCKS": "8"}
#: ranks of the data-parallel phase sharing the one card, and their time
#: limit in seconds
DP_RANKS = 2
DP_TIMEOUT = 300
#: the attention checks: (name, [B, S, H, D], causal).  BERT-base's shape
#: (bench_transformer.py's batch 8 × seq 512, 12 heads of 64) is the main
#: path's; the others cover causal masking, tail tiles and the head dims
ATTN_SHAPES = (("bert", (8, 512, 12, 64), False),
               ("bert_causal", (8, 512, 12, 64), True),
               ("odd", (2, 200, 3, 64), False),
               ("odd_causal", (2, 200, 3, 64), True),
               ("d80", (1, 77, 2, 80), False),
               ("d128_causal", (2, 130, 2, 128), True))
#: shapes timed as well as checked
ATTN_TIMED = ("bert", "bert_causal")
#: agreement with the plain versions: o and dq/dk/dv within these shares
#: of the plain result's largest magnitude (bf16 outputs; the kernels
#: round P and dS to bf16 before their products), lse absolute (f32)
O_TOL = 2.0 ** -7
GRAD_TOL = 2.0 ** -6
LSE_TOL = 1e-4
#: back-to-back calls per CUDA-event timing of the attention kernels
#: (~0.1-0.3 ms each) and of their yardstick
ATTN_INNER = 10
#: the bench's BERT batch, and the timed steps of ``fit_chunked`` in
#: chunks (one more warmup chunk runs first)
BERT_BATCH = 8
BERT_SEQ = 512
BERT_STEPS = 20
BERT_CHUNK = 10
#: rows of the ±inf binning check
INF_ROWS = 1_000_000
#: the cross-device check: a two-layer BERT whose heads the kernels take
#: (head dim 64), trained a few steps on the card and on the CPU (the
#: dense oracle) from the same weights, held as the CPU tests hold the
#: port to the JAX package
CROSS_BERT = dict(n_layers=2, d_model=128, n_heads=2, d_ff=256,
                  vocab_size=512, max_len=128)
CROSS_BERT_STEPS = 3
LOSS_RTOL = 2e-3
PARAM_ATOL = 1e-3
#: B5 on general g/h: the product variants within this share of each
#: plane's largest plain cell (both sum the same bf16 values in f32, in
#: other orders: 2^10 adds a tile in the worst case of 2^-24 each, far
#: above what occurs), and nodot within one bf16 rounding of its per-tile
#: sums (its bf16 rounding can flip where the f32 sums differ in the last
#: place)
FLOOR_TOL = 2.0 ** -12
NODOT_TOL = 2.0 ** -7
#: the bench child's time limit (s) and its rounds (the bench's default)
BENCH_TIMEOUT = 600
BENCH_ROUNDS = 100
BENCH_ROWS = 10_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def card_rates(name: str):
    """(HBM bytes/s, non-tensor-core f32 operations/s) of the card, from
    NVIDIA's data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s, H100 PCIe
    2.0 TB/s and 51 TFLOP/s."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12


def tensor_rate(name: str) -> float:
    """Dense bf16 tensor-core operations/s of the card (NVIDIA's data
    sheets: H100 SXM 989 TFLOP/s, H100 PCIe 756 TFLOP/s)."""
    return 756e12 if "PCIe" in name else 989e12


def time_ms(torch, fn, reps: int, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up;
    each timing spans ``inner`` calls back to back and is divided by
    ``inner`` (for kernels short enough that one call's host-side wrapper
    would show as idle device time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(torch, fn, reps: int, attempts: int = 3) -> float:
    """Device time of one call of ``fn``: each CUDA kernel's mean time in
    a ``torch.profiler`` trace of ``reps`` calls, times its launches per
    call, summed (no host gap counts, unlike a CUDA-event window around a
    host-heavy call).

    The tracer can drop a window's first records or deliver them late
    into the next window, so a kernel's launches per call are its count
    over ``reps`` rounded, and a kernel with fewer than half a launch a
    call is a stray of another window and left out; an empty window
    first takes any late records.  Up to ``attempts`` traces, then the
    measurement fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for evt in prof.key_averages():
            t = getattr(evt, "device_time_total", None)
            t = evt.cuda_time_total if t is None else t
            per_call = round(evt.count / reps)
            if t > 0 and per_call > 0:
                total += t / evt.count * per_call
        if total > 0:
            return total / 1e3
    raise RuntimeError(f"chip_smoke: no profiler trace of {reps} calls in "
                       f"{attempts} tries")


def steady_rounds_per_sec(tree_times) -> float:
    """1 / the mean time of trees 2.. (the first also pays each torch
    kernel's first launch on the card)."""
    return (len(tree_times) - 1) / (tree_times[-1] - tree_times[0])


def bound(nbytes: float, nops: float, rates):
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, device_mod, build_mod):
    smi = device_mod.gpu_name_and_power_limit()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    build_mod.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(build_mod.SIGNATURES)})
    return smi


def check_fused_round(torch, H, bins, g, h, masked, gen, n_prev, kg, kh,
                      rates, layout=None):
    """``fused_round`` at one level (``n_prev`` parents) against its
    plain version, twice over, in both split-table forms; then timed.
    Under a ``layout`` ``bins`` is the physical matrix, the split tables
    name ORIGINAL features and bins, and the histograms are in storage
    space (the layout mode)."""
    P, n = bins.shape
    if layout is None:
        F = S = P
        B = N_BINS
    else:
        F, S, B = layout.n_features, layout.storage_features, layout.sync_bins
    dev = bins.device
    nd = torch.randint(0, n_prev, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    nd = torch.where(masked, -1, nd).to(torch.int32)
    feat = torch.randint(0, F, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)
    if layout is None:
        thr = torch.randint(0, N_BINS - 1, (n_prev,), dtype=torch.int32,
                            device=dev, generator=gen)
    else:
        thr = torch.from_numpy(layout_thresholds(
            layout, feat.cpu().numpy(), n_prev)).to(dev)
    prev = H.hist_kernel(bins, nd, g, h, n_prev, B, kg, kh, layout)
    require(torch.equal(prev, H.hist_plain(bins, nd, g, h, n_prev, B, kg,
                                           kh, layout)),
            f"hist kernel != hist_plain (n_nodes={n_prev}, layout "
            f"{layout is not None})")

    def run(f_, t_, by_node):
        return H.fused_round_kernel(bins, nd, f_, t_, g, h, prev, n_prev, B,
                                    kg, kh, by_node, layout)

    a = run(feat, thr, True)
    b = run(feat, thr, True)
    c = H.fused_round_plain(bins, nd, feat, thr, g, h, prev, n_prev, B,
                            kg, kh, True, layout)
    torch.cuda.synchronize()
    what = f"(n_prev={n_prev}, layout {layout is not None})"
    require(torch.equal(a[0], c[0]), f"fused_round new_node != plain {what}")
    require(torch.equal(a[1], c[1]), f"fused_round hist != plain {what}")
    require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            f"fused_round not reproducible {what}")
    # per-row split arrays (the JAX signature) give the same result
    safe = nd.clamp(min=0).long()
    r = run(feat[safe], thr[safe], False)
    require(torch.equal(r[0], a[0]) and torch.equal(r[1], a[1]),
            f"fused_round per-row form differs {what}")
    routed = a[0] >= 0
    right_share = float((a[0][routed] % 2).float().mean())
    require(0.0 < right_share < 1.0,
            f"fused_round sent every row one way {what}")
    cells = n_prev * S * B
    nbytes = (P * n + 4 * n + 8 * n + 2 * cells * 4 + 8 * n_prev + 4 * n
              + 2 * 2 * cells * 4)
    b_ms, b_by = bound(nbytes, 2 * S * n, rates)
    return {
        "n_prev": n_prev, "right_share": right_share,
        "ms": time_ms(torch, lambda: run(feat, thr, True), REPS),
        "device_ms": device_ms(torch, lambda: run(feat, thr, True), REPS),
        "plain_ms": time_ms(torch, lambda: H.fused_round_plain(
            bins, nd, feat, thr, g, h, prev, n_prev, B, kg, kh, True,
            layout), max(3, REPS // 3)),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(max_abs_err(torch, a[1], c[1]),
                           max_abs_err(torch, a[0], c[0])),
        "bytes": nbytes}


def check_fused_descend(torch, H, bins, g, h, masked, gen, n_prev, kg, kh,
                        rates):
    """``fused_descend`` at one level (``n_prev`` parents) against its
    plain version, twice over, in both split-table forms, and against the
    unfused chain it replaces (``descend_kernel``, then ``hist`` over left
    children: ``fused_descend_histogram(fuse=False)``); then all three
    timed, the kernel and the chain also by device time."""
    F, n = bins.shape
    dev = bins.device
    nd = torch.randint(0, n_prev, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    nd = torch.where(masked, -1, nd).to(torch.int32)
    feat = torch.randint(0, F, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)
    thr = torch.randint(0, N_BINS - 1, (n_prev,), dtype=torch.int32,
                        device=dev, generator=gen)

    def run(f_, t_, by_node):
        return H.fused_descend_kernel(bins, nd, f_, t_, g, h, n_prev, N_BINS,
                                      kg, kh, by_node)

    def chain():
        return H.fused_descend_histogram(bins, nd, feat, thr, g, h, n_prev,
                                         N_BINS, fuse=False, by_node=True,
                                         scales=(kg, kh))

    a = run(feat, thr, True)
    b = run(feat, thr, True)
    c = H.fused_descend_plain(bins, nd, feat, thr, g, h, n_prev, N_BINS, kg,
                              kh, True)
    u = chain()
    torch.cuda.synchronize()
    what = f"(n_prev={n_prev})"
    require(torch.equal(a[1], c[1]), f"fused_descend new_node != plain {what}")
    require(torch.equal(a[0], c[0]), f"fused_descend hist != plain {what}")
    require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            f"fused_descend not reproducible {what}")
    require(torch.equal(a[0], u[0]) and torch.equal(a[1], u[1]),
            f"fused_descend differs from the unfused chain {what}")
    safe = nd.clamp(min=0).long()
    r = run(feat[safe], thr[safe], False)
    require(torch.equal(r[0], a[0]) and torch.equal(r[1], a[1]),
            f"fused_descend per-row form differs {what}")
    routed = a[1] >= 0
    right_share = float((a[1][routed] % 2).float().mean())
    require(0.0 < right_share < 1.0,
            f"fused_descend sent every row one way {what}")
    # bins, node in, new_node out, g/h, the left histograms out, tables
    nbytes = F * n + 4 * n + 4 * n + 8 * n + 2 * n_prev * F * N_BINS * 4 \
        + 8 * n_prev
    b_ms, b_by = bound(nbytes, 2 * F * n, rates)
    return {
        "n_prev": n_prev, "right_share": right_share,
        "ms": time_ms(torch, lambda: run(feat, thr, True), REPS),
        "plain_ms": time_ms(torch, lambda: H.fused_descend_plain(
            bins, nd, feat, thr, g, h, n_prev, N_BINS, kg, kh, True),
            max(3, REPS // 3)),
        "device_ms": device_ms(torch, lambda: run(feat, thr, True), REPS),
        "unfused_chain_ms": time_ms(torch, chain, REPS),
        "chain_device_ms": device_ms(torch, chain, REPS),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(max_abs_err(torch, a[0], c[0]),
                           max_abs_err(torch, a[1], c[1])),
        "bytes": nbytes}


def layout_thresholds(layout, feat, n_prev):
    """Per-node thresholds in the ORIGINAL bin space that split each
    node's feature: an occupied original bin other than the largest
    (a compact feature's remap lists them), or a bin below a wide
    feature's width — so both sides of every decoded feature are taken
    and the bundle decode and compact remap change where rows go."""
    import numpy as np

    from dmlc_core_tpu_torch.ops import binlayout as bl

    rng = np.random.default_rng([SEED, n_prev])
    owner = bl.layout_tables(layout)["owner"]
    thr = np.empty(len(feat), np.int32)
    for i, f in enumerate(feat):
        occ = layout.bin_maps[f]
        if occ is None:
            thr[i] = rng.integers(0, max(layout.widths[owner[f]] - 1, 1))
        else:
            occ = sorted(occ)
            thr[i] = occ[rng.integers(0, max(len(occ) - 1, 1))]
    return thr


def kernel_inputs(torch, H, bins=None):
    """The kernel checks' inputs, made on the card from ``SEED``: bins
    (random ``[FEATURES, ROWS]`` unless given), logistic g/h, a 1% mask of
    rows (node −1), the fixed-point scales and the generator for the split
    tables."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    if bins is None:
        bins = torch.randint(0, N_BINS, (FEATURES, ROWS), dtype=torch.uint8,
                             device=dev, generator=gen)
    n = bins.shape[1]
    margin = 0.5 * torch.randn(n, device=dev, generator=gen)
    p = torch.sigmoid(margin)
    y = (torch.rand(n, device=dev, generator=gen) < p).float()
    g, h = p - y, p * (1 - p)
    masked = torch.rand(n, device=dev, generator=gen) < 0.01
    kg, kh = H.hist_scales(g, h)
    return bins, g, h, masked, gen, kg, kh


def check_hist(torch, H, bins, g, h, masked, kg, kh, rates, layout=None):
    """``hist`` at the root against its plain version, twice over, then
    timed beside its bound and ``index_add_``'s time.  Under a ``layout``
    ``bins`` is the physical matrix and the histogram is in storage space
    (the layout mode)."""
    from dmlc_core_tpu_torch.ops import binlayout as bl

    dev = bins.device
    P, n = bins.shape
    B = N_BINS if layout is None else layout.sync_bins
    node = torch.where(masked, -1, 0).to(torch.int32)
    k1 = H.hist_kernel(bins, node, g, h, 1, B, kg, kh, layout)
    k2 = H.hist_kernel(bins, node, g, h, 1, B, kg, kh, layout)
    pl = H.hist_plain(bins, node, g, h, 1, B, kg, kh, layout)
    torch.cuda.synchronize()
    what = f"(layout {layout is not None})"
    require(torch.equal(k1, pl), f"hist kernel != hist_plain {what}")
    require(torch.equal(k1, k2), f"hist kernel not reproducible {what}")
    require(bool(torch.isfinite(k1).all()), "hist not finite")
    # the one-call library yardstick: index_add_ over a precomputed flat
    # (plane, storage feature, bin) index (index build left out of the
    # timing)
    store = bins if layout is None else bl.unpack_matrix(bins, layout)
    S = store.shape[0]
    valid = ~masked
    idx = (torch.arange(S, device=dev)[:, None] * B + store.long())
    idx = torch.cat([idx.reshape(-1), idx.reshape(-1) + S * B])
    vals = torch.cat([torch.where(valid, g, 0.0).expand(S, n).reshape(-1),
                      torch.where(valid, h, 0.0).expand(S, n).reshape(-1)])
    del store
    lib_out = torch.zeros(2 * S * B, device=dev)

    def lib_call():
        lib_out.zero_()
        lib_out.index_add_(0, idx, vals)

    lib_call()
    torch.cuda.synchronize()
    # f32 atomics over many rows per cell: agree to ~1e-6 of the largest
    lib_err = float((lib_out.reshape(2, 1, S, B) - k1).abs().max()
                    / k1.abs().max())
    require(lib_err < 1e-3, f"index_add_ yardstick disagrees ({lib_err})")
    t_lib = time_ms(torch, lib_call, REPS)
    del idx, vals
    nbytes = P * n + 4 * n + 8 * n + 2 * S * B * 4
    b_ms, b_by = bound(nbytes, 2 * S * n, rates)
    def kernel():
        return H.hist_kernel(bins, node, g, h, 1, B, kg, kh, layout)

    return {
        "ms": time_ms(torch, kernel, REPS),
        "device_ms": device_ms(torch, kernel, REPS),
        "plain_ms": time_ms(torch, lambda: H.hist_plain(
            bins, node, g, h, 1, B, kg, kh, layout), max(3, REPS // 3)),
        "library_ms": t_lib, "library_rel_err": lib_err, "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": max_abs_err(torch, k1, pl),
        "bytes": nbytes}


def summarize(cases, library_ms=None):
    """One ``kernels`` entry from several checked shapes: the mean time,
    device time, plain time and bound (and unfused chain time, where
    measured), the largest error."""
    mean = {k: statistics.fmean(c[k] for c in cases)
            for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                      "unfused_chain_ms", "chain_device_ms")
            if k in cases[0]}
    by = {c["bound_by"] for c in cases}
    return {**mean, "library_ms": library_ms,
            "bound_by": by.pop() if len(by) == 1 else "mixed",
            "max_abs_err": max(c["max_abs_err"] for c in cases)}


def check_inf_binning(torch, np):
    """``compute_cuts`` + ``apply_bins`` on the card (the device route)
    over a gaussian column, one with 1% +inf and one with 1% −inf: the
    cuts hold NaN (the top ones, and every one) and the card's bins equal
    the host route's (``_host_bin_t``) on the same cuts, bit for bit."""
    from dmlc_core_tpu_torch.models.gbt_split import _host_bin_t
    from dmlc_core_tpu_torch.ops.quantile import apply_bins, compute_cuts

    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(INF_ROWS, 3)).astype(np.float32)
    X[rng.random(INF_ROWS) < 0.01, 1] = np.inf
    X[rng.random(INF_ROWS) < 0.01, 2] = -np.inf
    Xd = torch.from_numpy(X).to(DEVICE)
    cuts = compute_cuts(Xd, N_BINS)
    bins = apply_bins(Xd, cuts).cpu().numpy()
    cuts_np = cuts.cpu().numpy()
    nan_cuts = np.isnan(cuts_np).sum(1).tolist()
    require(nan_cuts[0] == 0 and nan_cuts[1] > 0
            and nan_cuts[2] == N_BINS - 1,
            f"±inf columns: NaN cuts per feature {nan_cuts}")
    host = _host_bin_t(X, cuts_np)
    differ = (bins != host).sum(1).tolist()
    require(differ == [0, 0, 0],
            f"device bins differ from _host_bin_t on {differ} rows")
    emit({"phase": "binning_inf", "rows": INF_ROWS, "n_bins": N_BINS,
          "nan_cuts": nan_cuts, "rows_differing": differ})


def phase_kernels(torch, H, rates):
    """Each kernel against its plain version at the main path's shapes."""
    n, F, B = ROWS, FEATURES, N_BINS
    bins, g, h, masked, gen, kg, kh = kernel_inputs(torch, H)
    out = {"hist": check_hist(torch, H, bins, g, h, masked, kg, kh, rates)}
    emit({"phase": "kernel", "name": "hist", "n": n, "F": F, "B": B,
          "n_nodes": 1, **out["hist"]})
    # -- fused_round at every level of a depth-6 tree ----------------------
    cases = []
    for level in range(1, MAX_DEPTH):
        case = check_fused_round(torch, H, bins, g, h, masked, gen,
                                 1 << (level - 1), kg, kh, rates)
        cases.append(case)
        emit({"phase": "kernel", "name": "fused_round", "n": n, "F": F,
              "B": B, **case})
    # one entry per kernel: the mean over one depth-6 tree's five levels
    out["fused_round"] = summarize(cases)
    cases = []
    for level in range(1, MAX_DEPTH):
        case = check_fused_descend(torch, H, bins, g, h, masked, gen,
                                   1 << (level - 1), kg, kh, rates)
        cases.append(case)
        emit({"phase": "kernel", "name": "fused_descend", "n": n, "F": F,
              "B": B, **case})
    out["fused_descend"] = summarize(cases)
    return out


def phase_kernels_layout(torch, np, H, rates, X, y):
    """The layout modes at the covtype-schema shapes, through the layouts
    the model itself derives: 2a (pack + bundle, the bench's levers) and
    2b (pack only).  ``hist`` at the root and ``fused_round`` at
    ``LAYOUT_N_PREV``, each against its plain version.  Returns the
    entries of the ``kernels`` line and each configuration's layout and
    physical matrix."""
    from dmlc_core_tpu_torch import HistGBT

    hists, rounds, mats = [], [], {}
    for cfg, env in (("2a", BENCH_LEVERS), ("2b", PACK_ONLY)):
        with levers(env):
            dd = HistGBT(max_depth=MAX_DEPTH, n_bins=N_BINS,
                         device=DEVICE).make_device_data(X, y)
        lay = dd["layout"]
        require(lay is not None, f"config {cfg}: no layout fired")
        mats[cfg] = (lay, dd["bins_t"])
        bins, g, h, masked, gen, kg, kh = kernel_inputs(
            torch, H, dd["bins_t"])
        del dd
        shape = {"config": cfg, "n": bins.shape[1], "phys_rows": lay.phys_rows,
                 "S": lay.storage_features, "Bs": lay.sync_bins,
                 "pairs": len(lay.pairs),
                 "bundles": sum(len(m) > 1 for m in lay.members)}
        case = check_hist(torch, H, bins, g, h, masked, kg, kh, rates, lay)
        hists.append(case)
        emit({"phase": "kernels_layout", "name": "hist_layout", **shape,
              "n_nodes": 1, **case})
        for n_prev in LAYOUT_N_PREV:
            case = check_fused_round(torch, H, bins, g, h, masked, gen,
                                     n_prev, kg, kh, rates, lay)
            rounds.append(case)
            emit({"phase": "kernels_layout", "name": "fused_round_layout",
                  **shape, **case})
        del bins, g, h, masked
    return {"hist_layout": summarize(
                hists, statistics.fmean(c["library_ms"] for c in hists)),
            "fused_round_layout": summarize(rounds)}, mats


def phase_deep_kernels(torch, H, rates, mats):
    """``fused_round`` at the levels of deeper trees, where the histogram
    outgrows shared memory and the kernel adds into the global one: on
    the flagship's shapes at ``DEEP_N_PREV``, and in the layout mode on
    the physical matrices ``mats`` of 2a and 2b at ``DEEP_LAYOUT_N_PREV``.
    Run after the main path: run before it, they slow the fit's first
    tree by 10–30 ms (PERF.md)."""
    bins, g, h, masked, gen, kg, kh = kernel_inputs(torch, H)
    for n_prev in DEEP_N_PREV:
        case = check_fused_round(torch, H, bins, g, h, masked, gen, n_prev,
                                 kg, kh, rates)
        emit({"phase": "kernel", "name": "fused_round", "n": ROWS,
              "F": FEATURES, "B": N_BINS, "beyond_main_path": True, **case})
        case = check_fused_descend(torch, H, bins, g, h, masked, gen, n_prev,
                                   kg, kh, rates)
        emit({"phase": "kernel", "name": "fused_descend", "n": ROWS,
              "F": FEATURES, "B": N_BINS, "beyond_main_path": True, **case})
    del bins, g, h, masked
    for cfg, (lay, phys) in mats.items():
        bins, g, h, masked, gen, kg, kh = kernel_inputs(torch, H, phys)
        for n_prev in DEEP_LAYOUT_N_PREV:
            case = check_fused_round(torch, H, bins, g, h, masked, gen,
                                     n_prev, kg, kh, rates, lay)
            emit({"phase": "kernels_layout", "name": "fused_round_layout",
                  "config": cfg, "n": bins.shape[1],
                  "phys_rows": lay.phys_rows, "S": lay.storage_features,
                  "Bs": lay.sync_bins, "beyond_main_path": True, **case})


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def higgs_like(np, n, F, seed):
    """bench.py's HIGGS-like rule: dense gaussians, a nonlinear label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    return X, (margin > 0).astype(np.float32)


def covtype_like(np, n, seed):
    """Seeded synthetic rows with the schema of UCI Covertype (LIBSVM
    ``covtype.binary``): 10 integer-valued columns in the documented
    ranges (elevation 1859–3858, aspect 0–360, slope 0–66, distances to
    hydrology (horizontal ≥ 0, vertical −173–601), roads and fire points
    ≥ 0, hillshades 0–254); 4 one-hot wilderness columns at covtype's
    counts (scaled to ``n``); 40 one-hot soil columns from a Zipf(1.3)
    draw independent of wilderness; a nonlinear label, half positive."""
    rng = np.random.default_rng(seed)

    def ints(x, lo, hi):
        return np.clip(np.rint(x), lo, hi)

    X = np.zeros((n, COVTYPE_FEATURES), np.float32)
    X[:, 0] = ints(rng.normal(2959, 280, n), 1859, 3858)
    X[:, 1] = rng.integers(0, 361, n)
    X[:, 2] = ints(rng.gamma(3.0, 4.7, n), 0, 66)
    X[:, 3] = ints(rng.exponential(270, n), 0, 1397)
    X[:, 4] = ints(rng.normal(46, 58, n), -173, 601)
    X[:, 5] = ints(rng.exponential(2350, n), 0, 7117)
    X[:, 6] = ints(rng.normal(212, 27, n), 0, 254)
    X[:, 7] = ints(rng.normal(223, 20, n), 0, 254)
    X[:, 8] = ints(rng.normal(143, 38, n), 0, 254)
    X[:, 9] = ints(rng.exponential(1980, n), 0, 7173)
    counts = np.floor(np.array(WILDERNESS_COUNTS) * n
                      / sum(WILDERNESS_COUNTS)).astype(np.int64)
    counts[0] += n - counts.sum()
    wild = rng.permutation(np.repeat(np.arange(4), counts))
    X[np.arange(n), 10 + wild] = 1.0
    p = np.arange(1, 41, dtype=np.float64) ** -1.3
    soil = rng.choice(40, n, p=p / p.sum())
    X[np.arange(n), 14 + soil] = 1.0
    # the label's soil effects are part of the schema: one fixed draw,
    # whatever the data's seed and size
    effect = np.random.default_rng(LABEL_SEED).normal(0.0, 0.8, 40)
    z = (((X[:, 0] - 2950) / 280) ** 2 + 0.5 * (wild == 1)
         - 0.7 * (wild == 3) + effect[soil]
         + 0.3 * np.sin(np.deg2rad(X[:, 1])) - 0.02 * X[:, 2]
         + 0.5 * rng.normal(size=n))
    return X, (z < np.median(z)).astype(np.float32)


@contextlib.contextmanager
def levers(env):
    """The model's levers (``DMLC_*`` environment) set for a block, as the
    bench sets them, and restored after."""
    saved = {k: os.environ.get(k) for k in LEVER_NAMES}
    for k in LEVER_NAMES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# the model's paths
# ---------------------------------------------------------------------------

def zero_counts(H):
    for fn in (H.hist_kernel, H.fused_round_kernel):
        fn.launches = 0
        fn.layout_launches = 0
    H.fused_descend_kernel.launches = 0


def read_counts(H):
    return {"hist": H.hist_kernel.launches,
            "fused_round": H.fused_round_kernel.launches,
            "hist_layout": H.hist_kernel.layout_launches,
            "fused_round_layout": H.fused_round_kernel.layout_launches,
            "fused_descend": H.fused_descend_kernel.launches}


def fit_path(torch, np, H, X, y, Xv, yv, env, min_acc):
    """Drive one path: ``HistGBT.fit`` under ``env`` with the launch
    counts set to 0 just before and read just after, train logloss after
    every round (replayed from the trees), held-out accuracy, and
    ``save_model`` → ``load_model`` giving the same predictions."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.models.histgbt import _predict_trees
    from dmlc_core_tpu_torch.ops.quantile import apply_bins

    model = HistGBT(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS,
                    device=DEVICE)
    with levers(env):
        zero_counts(H)
        t0 = time.perf_counter()
        model.fit(X, y)
        wall_s = time.perf_counter() - t0
        launches = read_counts(H)
    n = len(X)
    bins_t = apply_bins(torch.from_numpy(X).to(DEVICE), model.cuts)
    y_d = torch.from_numpy(y).to(DEVICE)
    stacked = model._stacked_trees(model.trees)
    margin = torch.zeros(n, device=DEVICE)
    losses = []
    for t in range(TREES):
        margin = _predict_trees(bins_t, stacked["feat"][t:t + 1],
                                stacked["thr"][t:t + 1],
                                stacked["leaf"][t:t + 1], MAX_DEPTH, margin)
        losses.append(float(model._obj.metric(margin, y_d)))
    del bins_t
    require(all(b < a for a, b in zip(losses, losses[1:])) and
            losses[0] < float(np.log(2.0)),
            f"train logloss did not fall every round: {losses}")
    require(torch.equal(margin.cpu(), torch.from_numpy(model.train_margins())),
            "replayed margins differ from the fit's")
    pv = model.predict(Xv)
    require(pv.shape == (len(Xv),) and np.isfinite(pv).all()
            and pv.min() >= 0.0 and pv.max() <= 1.0,
            "held-out predictions malformed")
    acc = float(((pv > 0.5) == (yv > 0.5)).mean())
    require(acc > min_acc, f"held-out accuracy {acc} too low")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.bin")
        model.save_model(path)
        again = HistGBT.load_model(path, device=DEVICE)
        require(np.array_equal(again.predict(Xv), pv),
                "load_model predictions differ")
        with open(path, "rb") as f:
            model_bytes = f.read()
    stats = {"rows": n, "features": X.shape[1], "trees": TREES,
             "max_depth": MAX_DEPTH, "n_bins": N_BINS, "levers": env,
             "fit_seconds": model.last_fit_seconds,
             "rounds_per_sec": TREES / model.last_fit_seconds,
             # trees 2.. only: the first tree also pays each torch
             # kernel's first launch on the card
             "steady_rounds_per_sec": steady_rounds_per_sec(
                 model.last_tree_times),
             "tree_times": model.last_tree_times,
             "bin_seconds": model.last_bin_seconds,
             "fit_wall_seconds": wall_s, "train_logloss": losses,
             "holdout_accuracy": acc, "launches": launches}
    return model, stats, model_bytes


def require_launches(launches, want, what):
    for k, v in want.items():
        require(launches[k] == v,
                f"{what}: {k} launched {launches[k]} times, want {v}")


def phase_main(torch, np, H, rates, X, y, Xv, yv):
    """The depth-wise fit at the flagship's shapes (default levers)."""
    _, stats, model_bytes = fit_path(torch, np, H, X, y, Xv, yv, {}, 0.6)
    require_launches(stats["launches"], {
        "hist": TREES, "fused_round": (MAX_DEPTH - 1) * TREES,
        "hist_layout": 0, "fused_round_layout": 0, "fused_descend": 0},
        "main")
    # a round streams the [F, n] bin matrix once per level (fused) at the
    # least: the floor of a round's time on this card's HBM
    round_bytes = H.bins_bytes_per_round(MAX_DEPTH, ROWS, FEATURES,
                                         fused=True)
    emit({"phase": "main", **stats, "round_bin_bytes": round_bytes,
          "round_bound_ms": round_bytes / rates[0] * 1e3,
          "hist_builds_per_round": H.leaves_built_per_round(MAX_DEPTH)})
    return stats, model_bytes


def phase_main_lossguide(torch, np, H, rates, X, y, Xv, yv):
    """Configuration 1: the bench's flagship levers (lossguide, 16
    leaves, int4 packing, feature bundling) on the HIGGS-like data, where
    neither bin lever fires."""
    model, stats, model_bytes = fit_path(torch, np, H, X, y, Xv, yv,
                                         BENCH_LEVERS, 0.6)
    require(model._bin_layout is None,
            "configuration 1: a bin layout fired on HIGGS-like data")
    require_launches(stats["launches"], {
        "hist": TREES, "fused_round": (MAX_LEAVES - 1) * TREES,
        "hist_layout": 0, "fused_round_layout": 0, "fused_descend": 0},
        "main_lossguide")
    kw = dict(grow_policy="lossguide", max_leaves=MAX_LEAVES, fused=True)
    round_bytes = H.bins_bytes_per_round(MAX_DEPTH, ROWS, FEATURES, **kw)
    emit({"phase": "main_lossguide", **stats, "bin_layout": None,
          "launches_per_tree": {k: v / TREES
                                for k, v in stats["launches"].items()},
          "round_bin_bytes": round_bytes,
          "round_bound_ms": round_bytes / rates[0] * 1e3,
          "hist_builds_per_round": H.leaves_built_per_round(
              MAX_DEPTH, "lossguide", MAX_LEAVES)})
    return stats, model_bytes


def phase_levers(torch, np, H, rates, X, y, Xv, yv):
    """Configurations 2a (pack + bundle) and 2b (pack only) at covtype's
    row count, each against the same lossguide fit with both levers off:
    2b's model file byte-identical, 2a's split structure identical."""
    off, off_stats, off_bytes = fit_path(torch, np, H, X, y, Xv, yv,
                                         LEVERS_OFF, 0.7)
    require(off._bin_layout is None, "levers-off fit has a layout")
    total = {k: 0 for k in off_stats["launches"]}
    for cfg, env in (("2a", BENCH_LEVERS), ("2b", PACK_ONLY)):
        model, stats, model_bytes = fit_path(torch, np, H, X, y, Xv, yv, env,
                                             0.7)
        lay = model._bin_layout
        require(lay is not None, f"config {cfg}: no layout fired")
        n_bundles = sum(len(m) > 1 for m in lay.members)
        if cfg == "2a":
            require(n_bundles >= 1, "config 2a: no feature bundle")
            require(all(np.array_equal(a["feat"], b["feat"])
                        and np.array_equal(a["thr"], b["thr"])
                        for a, b in zip(off.trees, model.trees)),
                    "config 2a: split structure differs from levers off")
        else:
            require(len(lay.pairs) >= 1, "config 2b: no int4 pair")
            require(model_bytes == off_bytes,
                    "config 2b: model file differs from levers off")
        require_launches(stats["launches"], {
            "hist": 0, "fused_round": 0, "hist_layout": TREES,
            "fused_round_layout": (MAX_LEAVES - 1) * TREES,
            "fused_descend": 0}, cfg)
        for k, v in stats["launches"].items():
            total[k] += v
        kw = dict(grow_policy="lossguide", max_leaves=MAX_LEAVES, fused=True)
        round_bytes = H.bins_bytes_per_round(MAX_DEPTH, len(X),
                                             lay.phys_rows, **kw)
        emit({"phase": "levers", "config": cfg, **stats,
              "layout": {"phys_rows": lay.phys_rows,
                         "storage_features": lay.storage_features,
                         "sync_bins": lay.sync_bins,
                         "pairs": len(lay.pairs), "bundles": n_bundles,
                         "bundle_widths": [lay.widths[s] for s, m in
                                           enumerate(lay.members)
                                           if len(m) > 1]},
              "levers_off_rounds_per_sec": off_stats["rounds_per_sec"],
              "levers_off_steady_rounds_per_sec":
                  off_stats["steady_rounds_per_sec"],
              "same_structure_as_levers_off": all(
                  np.array_equal(a["feat"], b["feat"])
                  and np.array_equal(a["thr"], b["thr"])
                  for a, b in zip(off.trees, model.trees)),
              "same_model_file_as_levers_off": model_bytes == off_bytes,
              "round_bin_bytes": round_bytes,
              "round_bound_ms": round_bytes / rates[0] * 1e3})
    return total


def phase_cross_device(np, slices):
    """Each configuration on a ``CROSS_ROWS`` slice, fit on the card and
    on the CPU (plain versions): every tree bit-identical."""
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    for name, (X, y, env) in slices.items():
        with levers(env):
            gpu = HistGBT(device=DEVICE, **kw).fit(X, y)
            cpu = HistGBT(device="cpu", **kw).fit(X, y)
        require(np.array_equal(gpu.cuts.cpu().numpy().view(np.uint32),
                               cpu.cuts.numpy().view(np.uint32)),
                f"{name}: cuts differ between cuda and cpu")
        require((gpu._bin_layout is None) == (cpu._bin_layout is None)
                and (gpu._bin_layout is None
                     or tuple(gpu._bin_layout) == tuple(cpu._bin_layout)),
                f"{name}: layouts differ between cuda and cpu")
        for i, (a, b) in enumerate(zip(gpu.trees, cpu.trees)):
            for key in ("feat", "thr", "gain", "leaf"):
                require(a[key].tobytes() == b[key].tobytes(),
                        f"{name}: tree {i} {key} differs between cuda and "
                        "cpu")
        pg, pc = gpu.predict(X), cpu.predict(X)
        require(np.array_equal(pg, pc),
                f"{name}: cuda and cpu predictions differ")
        emit({"phase": "cross_device", "config": name, "rows": len(X),
              "trees": TREES, "levers": env,
              "layout_phys_rows": (None if gpu._bin_layout is None
                                   else gpu._bin_layout.phys_rows),
              "identical_trees": len(gpu.trees),
              "max_abs_pred_diff": float(np.abs(pg - pc).max())})


def phase_data_parallel(torch, np, H, rates, X, y, Xv, yv, main, lossguide):
    """The data-parallel path on this card.  ``main`` / ``lossguide``:
    ``(stats, model bytes)`` of phases 4 and 5.  Returns the launches of
    every fit, summed."""
    from dmlc_core_tpu_torch.base.metrics import default_registry
    from dmlc_core_tpu_torch.parallel import collectives as coll
    from dmlc_core_tpu_torch.parallel.launch import free_port, launch

    def allreduces():
        m = default_registry().snapshot()["metrics"].get(
            "dmlc_collective_calls_total")
        return sum(s["value"] for s in m["series"]
                   if s["labels"]["op"] == "device_allreduce") if m else 0

    # (a) a NCCL group of one: the synced path with the fused descend
    torch.cuda.set_device(0)
    coll.init({"DMLC_NUM_WORKER": "1", "DMLC_TRACKER_URI": "127.0.0.1",
               "DMLC_TRACKER_PORT": str(free_port()), "DMLC_TASK_ID": "0"},
              backend="nccl")
    try:
        require(coll.world_size() == 1, "NCCL group of one did not form")
        calls0 = allreduces()
        _, stats, model_bytes = fit_path(torch, np, H, X, y, Xv, yv,
                                         DP_BLOCKS, 0.6)
        n_allreduce = allreduces() - calls0
    finally:
        coll.finalize()
    require_launches(stats["launches"], {
        "hist": TREES, "fused_round": 0, "hist_layout": 0,
        "fused_round_layout": 0,
        "fused_descend": (MAX_DEPTH - 1) * TREES}, "data_parallel (a)")
    require(model_bytes == main[1],
            "data_parallel (a): model file differs from the main fit's")
    require(n_allreduce == MAX_DEPTH * TREES,
            f"data_parallel (a): {n_allreduce} all-reduces, want "
            f"{MAX_DEPTH * TREES}")
    total = dict(stats["launches"])
    emit({"phase": "data_parallel", "part": "a", "backend": "nccl",
          "world": 1, **stats, "device_allreduces": n_allreduce,
          "same_model_file_as_main": True,
          "main_steady_rounds_per_sec": main[0]["steady_rounds_per_sec"]})

    # (b) two ranks sharing the card (gloo), and (c) the int8 sync
    runs = {"depthwise": (FUSED_DESCEND, main),
            "lossguide": ({**BENCH_LEVERS, **FUSED_DESCEND}, lossguide),
            "quant": ({**FUSED_DESCEND, "DMLC_HIST_QUANT": "1"}, None)}
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "X.npy"), X)
        np.save(os.path.join(d, "y.npy"), y)
        np.save(os.path.join(d, "Xv.npy"), Xv)
        t0 = time.perf_counter()
        launch({"X": os.path.join(d, "X.npy"),
                "y": os.path.join(d, "y.npy"),
                "Xv": os.path.join(d, "Xv.npy"), "backend": "gloo",
                "device": "cuda:0", "threads": 1,
                "params": {"n_trees": TREES, "max_depth": MAX_DEPTH,
                           "n_bins": N_BINS},
                "runs": [{"name": k, "env": env}
                         for k, (env, _) in runs.items()],
                "out": os.path.join(d, "out")}, DP_RANKS, DP_TIMEOUT)
        group_s = time.perf_counter() - t0
        out = os.path.join(d, "out")
        margins = {k: np.load(os.path.join(out, f"{k}.margins.npy"))
                   for k in runs}
        preds = {k: np.load(os.path.join(out, f"{k}.pred.npy"))
                 for k in runs}
        for name, (env, ref) in runs.items():
            ranks = []
            for r in range(DP_RANKS):
                with open(os.path.join(out, f"{name}.{r}.json")) as f:
                    st = json.load(f)
                with open(os.path.join(out, f"{name}.{r}.model"), "rb") as f:
                    st["model_bytes"] = f.read()
                ranks.append(st)
                for k, v in st["launches"].items():
                    total[k] += v
            builds = (MAX_LEAVES - 1 if name == "lossguide"
                      else MAX_DEPTH - 1) * TREES
            for r, st in enumerate(ranks):
                require_launches(st["launches"], {
                    "hist": TREES, "fused_round": 0, "hist_layout": 0,
                    "fused_round_layout": 0, "fused_descend": builds},
                    f"data_parallel {name} rank {r}")
                require(st["model_bytes"] == ranks[0]["model_bytes"],
                        f"data_parallel {name}: rank {r}'s model differs")
            acc = float(((preds[name] > 0) == (yv > 0.5)).mean())
            require(np.isfinite(margins[name]).all()
                    and margins[name].shape == (len(X),),
                    f"data_parallel {name}: margins malformed")
            require(acc > 0.6, f"data_parallel {name}: held-out accuracy "
                    f"{acc} too low")
            line = {"phase": "data_parallel", "backend": "gloo",
                    "world": DP_RANKS, "config": name, "levers": env,
                    "rows_per_rank": [len(X) // DP_RANKS,
                                      len(X) - len(X) // DP_RANKS],
                    "launches_per_rank": ranks[0]["launches"],
                    "fit_seconds": [st["fit_seconds"] for st in ranks],
                    "steady_rounds_per_sec": [
                        steady_rounds_per_sec(st["tree_times"])
                        for st in ranks],
                    "device_allreduces": ranks[0]["device_allreduces"],
                    "hist_sync_bytes": ranks[0]["hist_sync_bytes"],
                    "holdout_accuracy": acc, "group_seconds": group_s}
            if ref is not None:
                require(ranks[0]["model_bytes"] == ref[1],
                        f"data_parallel {name}: model file differs from "
                        "the 1-process fit's")
                line.update(part="b", same_model_file_as_one_process=True,
                            one_process_steady_rounds_per_sec=ref[0][
                                "steady_rounds_per_sec"])
            else:
                diff = np.abs(margins[name] - margins["depthwise"])
                line.update(part="c", margin_max_abs_diff=float(diff.max()),
                            margin_mean_abs_diff=float(diff.mean()))
            emit(line)
    return total


# ---------------------------------------------------------------------------
# attention and BERT
# ---------------------------------------------------------------------------

def rel_err(a, b) -> float:
    """max|a − b| over max|b|."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def attention_bounds(shape, causal, rates, tc_rate):
    """``{kernel: (bound ms, bound_by)}``: the bytes each kernel must move
    (bf16 [B, S, H, D] tensors and f32 [B, H, S] residuals, each read or
    written once) at the HBM rate against its tensor-core products over
    the (query, key) pairs it visits, at the bf16 rate."""
    B, S, H, D = shape
    t = B * S * H * D * 2
    r = B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    rr = (rates[0], tc_rate)
    return {"flash_fwd": bound(3 * t + t + r, 4 * pairs * D, rr),
            "flash_bwd_dkv": bound(4 * t + 2 * r + 2 * t, 8 * pairs * D, rr),
            "flash_bwd_dq": bound(4 * t + 2 * r + t, 6 * pairs * D, rr)}


def check_attention(torch, A, name, shape, causal, rates, tc_rate):
    """The three flash kernels at one shape against their plain versions
    on the same card inputs, twice over; at the timed shapes, timed
    beside their bounds and SDPA's time.  Returns ``{kernel: entry}``."""
    import torch.nn.functional as F

    B, S, H, D = shape
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    qkv = torch.randn((3, B, S, H, D), device=dev,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(0)    # views of one tensor, as BERT's QKV gives
    do = torch.randn((B, S, H, D), device=dev,
                     generator=gen).to(torch.bfloat16)
    scale = D ** -0.5
    what = f"({name}, {list(shape)}, causal {causal})"

    def fwd():
        return A.flash_fwd_kernel(q, k, v, causal, scale)

    o, lse = fwd()
    o2, lse2 = fwd()
    o_p, lse_p = A.flash_fwd_plain(q, k, v, causal, scale)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()

    def dkv():
        return A.flash_bwd_dkv_kernel(q, k, v, do, lse, di, causal, scale)

    def dq_fn():
        return A.flash_bwd_dq_kernel(q, k, v, do, lse, di, causal, scale)

    dk, dv = dkv()
    dk2, dv2 = dkv()
    dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal, scale)
    dq = dq_fn()
    dq2 = dq_fn()
    dq_p = A.flash_bwd_dq_plain(q, k, v, do, lse, di, causal, scale)
    torch.cuda.synchronize()
    for out in (o, lse, dk, dv, dq):
        require(bool(torch.isfinite(out).all()), f"non-finite output {what}")
    require(torch.equal(o, o2) and torch.equal(lse, lse2),
            f"flash_fwd not reproducible {what}")
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2),
            f"flash_bwd_dkv not reproducible {what}")
    require(torch.equal(dq, dq2), f"flash_bwd_dq not reproducible {what}")
    errs = {"o": rel_err(o, o_p), "dk": rel_err(dk, dk_p),
            "dv": rel_err(dv, dv_p), "dq": rel_err(dq, dq_p)}
    lse_err = max_abs_err(torch, lse, lse_p)
    require(errs["o"] <= O_TOL, f"flash_fwd o off its plain version by "
            f"{errs['o']} of max|o| {what}")
    require(lse_err <= LSE_TOL, f"flash_fwd lse off by {lse_err} {what}")
    for key in ("dk", "dv", "dq"):
        require(errs[key] <= GRAD_TOL, f"{key} off its plain version by "
                f"{errs[key]} of its largest magnitude {what}")
    out = {"flash_fwd": {"max_abs_err": max_abs_err(torch, o, o_p),
                         "rel_err": errs["o"], "lse_max_abs_err": lse_err},
           "flash_bwd_dkv": {"max_abs_err": max(max_abs_err(torch, dk, dk_p),
                                                max_abs_err(torch, dv, dv_p)),
                             "rel_err": max(errs["dk"], errs["dv"])},
           "flash_bwd_dq": {"max_abs_err": max_abs_err(torch, dq, dq_p),
                            "rel_err": errs["dq"]}}
    if name not in ATTN_TIMED:
        return out
    # the yardstick: PyTorch's fused attention on the same inputs in its
    # [B, H, S, D] layout (views), forward and forward + backward
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    leaves = [t.detach().clone().requires_grad_() for t in (qt, kt, vt)]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)

    # the backward alone: the forward runs once, outside the timing, and
    # each call walks its retained graph
    res = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         scale=scale)

    def sdpa_bwd():
        return torch.autograd.grad(res, leaves, dot, retain_graph=True)

    n = ATTN_INNER
    with torch.no_grad():
        lib_rel = rel_err(sdpa().transpose(1, 2), o_p)
        lib_fwd = time_ms(torch, sdpa, REPS, n)
        lib_fwd_dev = device_ms(torch, sdpa, REPS)
    lib_bwd = time_ms(torch, sdpa_bwd, REPS, n)
    lib_bwd_dev = device_ms(torch, sdpa_bwd, REPS)
    plain_reps = max(3, REPS // 3)
    dev = {"flash_fwd": device_ms(torch, fwd, REPS),
           "flash_bwd_dkv": device_ms(torch, dkv, REPS),
           "flash_bwd_dq": device_ms(torch, dq_fn, REPS)}
    times = {
        "flash_fwd": (time_ms(torch, fwd, REPS, n), time_ms(
            torch, lambda: A.flash_fwd_plain(q, k, v, causal, scale),
            plain_reps), lib_fwd),
        "flash_bwd_dkv": (time_ms(torch, dkv, REPS, n), time_ms(
            torch, lambda: A.flash_bwd_dkv_plain(q, k, v, do, lse, di,
                                                 causal, scale),
            plain_reps), lib_bwd),
        "flash_bwd_dq": (time_ms(torch, dq_fn, REPS, n), time_ms(
            torch, lambda: A.flash_bwd_dq_plain(q, k, v, do, lse, di,
                                                causal, scale),
            plain_reps), lib_bwd)}
    for kname, (b_ms, b_by) in attention_bounds(shape, causal, rates,
                                                tc_rate).items():
        ms, plain_ms, lib_ms = times[kname]
        out[kname].update(ms=ms, device_ms=dev[kname], plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          library_device_ms=(lib_fwd_dev if kname ==
                                             "flash_fwd" else lib_bwd_dev),
                          sdpa_rel_err=lib_rel)
    return out


def phase_attention_kernels(torch, A, rates, tc_rate):
    """Every ``ATTN_SHAPES`` check; returns the ``kernels`` entries, from
    BERT-base's non-causal shape (the main path's)."""
    entries = None
    for name, shape, causal in ATTN_SHAPES:
        res = check_attention(torch, A, name, shape, causal, rates, tc_rate)
        for kname, case in res.items():
            emit({"phase": "attention_kernels", "name": kname,
                  "shape": name, "B_S_H_D": list(shape), "causal": causal,
                  **case})
        if name == "bert":
            entries = res
    # SDPA's backward computes dq, dk and dv in one call: it stands beside
    # each backward kernel as the time of the whole backward
    for kname in ("flash_bwd_dkv", "flash_bwd_dq"):
        entries[kname]["library_call"] = "sdpa backward (dq, dk, dv)"
    entries["flash_fwd"]["library_call"] = "sdpa forward"
    return entries


def zero_attention_counts(A):
    for fn in (A.flash_fwd_kernel, A.flash_bwd_dkv_kernel,
               A.flash_bwd_dq_kernel):
        fn.launches = 0


def read_attention_counts(A):
    return {"flash_fwd": A.flash_fwd_kernel.launches,
            "flash_bwd_dkv": A.flash_bwd_dkv_kernel.launches,
            "flash_bwd_dq": A.flash_bwd_dq_kernel.launches}


def phase_bert(torch, np, A, rates):
    """BERT-base masked-LM training on the card (the bench's batch): one
    step, the chunked steps with launch counts read around them, then the
    save / load round trip.  Returns the chunked steps' launches."""
    from dmlc_core_tpu_torch.models import BERT

    t0 = time.perf_counter()
    model = BERT(device=DEVICE)
    model.init_params(0)
    p = model.param
    n_params = sum(int(t.numel()) for t in model.params.values())
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, p.vocab_size, size=(BERT_BATCH, BERT_SEQ))
    labels, mask = tokens.copy(), np.ones(tokens.shape, np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = model.train_step(tokens, labels, mask)
    first_step_s = time.perf_counter() - t0
    # random weights of scale 0.02: the loss starts near ln V
    require(math.isfinite(first)
            and abs(first - math.log(p.vocab_size)) < 1.0,
            f"first BERT loss {first}, want about ln {p.vocab_size}")
    zero_attention_counts(A)
    final, secs, chunk_times = model.fit_chunked(
        tokens, labels, mask, n_steps=BERT_STEPS, chunk=BERT_CHUNK)
    launches = read_attention_counts(A)
    steps_run = BERT_STEPS + BERT_CHUNK
    for kname, n in launches.items():
        require(n == p.n_layers * steps_run,
                f"bert: {kname} launched {n} times in {steps_run} steps, "
                f"want {p.n_layers} per step")
    require(math.isfinite(final) and final < first,
            f"BERT loss did not fall: {first} -> {final}")
    peak = torch.cuda.max_memory_allocated()
    flops = 6 * n_params * BERT_BATCH * BERT_SEQ
    steps_per_sec = BERT_STEPS / secs
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bert.bin")
        t0 = time.perf_counter()
        model.save_model(path)
        again = BERT.load_model(path, device=DEVICE)
        file_bytes = os.path.getsize(path)
        save_load_s = time.perf_counter() - t0
    for tree, other in ((model.params, again.params),
                        (model.opt_state, again.opt_state)):
        require(list(tree) == list(other)
                and all(torch.equal(tree[k], other[k]) for k in tree),
                "bert: load_model's weights or momentum differ")
    nxt, nxt_again = (m.train_step(tokens, labels, mask)
                      for m in (model, again))
    require(nxt == nxt_again,
            f"bert: the loaded model's next loss {nxt_again} != {nxt}")
    cross = bert_cross_device(torch, np, A)
    emit({"phase": "bert", "param": p.to_dict(), "params": n_params,
          "batch": BERT_BATCH, "seq": BERT_SEQ, "init_seconds": init_s,
          "first_step_seconds": first_step_s, "first_loss": first,
          "steps": BERT_STEPS, "chunk": BERT_CHUNK, "seconds": secs,
          "final_loss": final, "chunk_times": chunk_times,
          "steps_per_sec": steps_per_sec,
          "tokens_per_sec": steps_per_sec * BERT_BATCH * BERT_SEQ,
          "matmul_flops_per_step": flops,
          "achieved_tflops": flops * steps_per_sec / 1e12,
          "f32_peak_share": flops * steps_per_sec / rates[1],
          "launches": launches,
          "launches_per_step": {k: v / steps_run
                                for k, v in launches.items()},
          "max_memory_allocated": peak, "model_file_bytes": file_bytes,
          "save_load_seconds": save_load_s, "next_loss": nxt,
          "round_trip_exact": True, "cross_device": cross})
    return launches


def bert_cross_device(torch, np, A):
    """``CROSS_BERT`` from one seed on the card (flash kernels) and on the
    CPU (dense oracle): losses within ``LOSS_RTOL``, weights within
    ``PARAM_ATOL`` after ``CROSS_BERT_STEPS`` steps."""
    from dmlc_core_tpu_torch.models import BERT

    gpu, cpu = BERT(device=DEVICE, **CROSS_BERT), BERT(device="cpu",
                                                       **CROSS_BERT)
    for m in (gpu, cpu):
        m.init_params(1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CROSS_BERT["vocab_size"],
                          size=(2, CROSS_BERT["max_len"]))
    mask = (rng.uniform(size=tokens.shape) < 0.3).astype(np.float32)
    batch = (tokens, tokens.copy(), mask)
    before = A.flash_fwd_kernel.launches
    lg = [gpu.train_step(*batch) for _ in range(CROSS_BERT_STEPS)]
    require(A.flash_fwd_kernel.launches - before
            == CROSS_BERT["n_layers"] * CROSS_BERT_STEPS,
            "bert cross-device: the card's model missed the kernels")
    lc = [cpu.train_step(*batch) for _ in range(CROSS_BERT_STEPS)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    param_err = max(max_abs_err(torch, gpu.params[k].detach().cpu(),
                                cpu.params[k].detach())
                    for k in cpu.params)
    require(loss_rel <= LOSS_RTOL and param_err <= PARAM_ATOL,
            f"bert cross-device: losses {lg} vs {lc}, weights off by "
            f"{param_err}")
    return {"config": CROSS_BERT, "steps": CROSS_BERT_STEPS,
            "losses_cuda": lg, "losses_cpu": lc, "loss_max_rel_diff": loss_rel,
            "param_max_abs_diff": param_err}


# ---------------------------------------------------------------------------
# B5: the one-hot product histogram, and the port's bench
# ---------------------------------------------------------------------------

def floor_rel_err(torch, a, b, nh):
    """max over the g and h planes of max|a − b| / max|b| (rows ``[0,
    nh)`` are the g plane, ``[nh, 2·nh)`` the h plane)."""
    errs = []
    for rows in (slice(0, nh), slice(nh, 2 * nh)):
        d = (a[:, rows].double() - b[:, rows].double()).abs().max()
        errs.append(float(d / b[:, rows].double().abs().max()))
    return max(errs)


def phase_hist_floor(torch, np, H, rates, tc_rate):
    """B5's variants at the spike's shapes against their plain versions,
    then its main path (slope timing) with the launch counts read around
    it.  Returns the ``kernels`` entries of the variants."""
    from dmlc_core_tpu_torch.ops.histogram import _TILE_ROWS, _lo_factor
    from dmlc_core_tpu_torch.tools import spike_hist_floor as S

    cases = {v: [] for v in S.VARIANTS}
    spike = {"rows": ROWS, "features": FEATURES, "tile": _TILE_ROWS}
    for n_build in (1, 2):
        bins, node, g, h = S._prep(n_build, ROWS, FEATURES, DEVICE)
        fp = FEATURES - FEATURES % S.GROUP
        bins_fp = bins[:fp]
        lo = _lo_factor(n_build, N_BINS)
        hi = -(-N_BINS // lo)
        nh = n_build * hi
        A = 2 * nh
        rows = ROWS // _TILE_ROWS * _TILE_ROWS
        # order-exact g/h: every sum exact, so every order gives its bytes
        rng = np.random.default_rng([SEED, n_build])
        ge = torch.from_numpy(rng.choice(np.array(
            [-1.0, -0.5, 0.5, 1.0], np.float32), ROWS)).to(DEVICE)
        he = torch.from_numpy(rng.choice(np.array(
            [0.5, 1.0], np.float32), ROWS)).to(DEVICE)
        ref = S.factored(H.build_histogram(
            bins_fp[:, :rows].contiguous(), node[:rows], ge[:rows],
            he[:rows], n_build, N_BINS), lo)
        nbytes = fp * rows + 12 * rows + fp * A * lo * 4
        # the function is a g/h histogram: two adds per row and feature,
        # as B1's bound counts it; the one-hot product's own floor (its
        # useful bf16 multiply-adds on the tensor cores) is kept apart
        b_ms, b_by = bound(nbytes, 2 * fp * rows, rates)
        product_flop_ms = 2 * A * lo * rows * fp / tc_rate * 1e3
        valid = (node >= 0) & (node < n_build)
        idx = ((node.long()[None, :] * fp
                + torch.arange(fp, device=node.device)[:, None]) * N_BINS
               + bins_fp.long())[:, valid].reshape(-1)
        idx = torch.cat([idx, idx + n_build * fp * N_BINS])
        vals = torch.cat([g[valid].expand(fp, -1).reshape(-1),
                          h[valid].expand(fp, -1).reshape(-1)])
        lib_out = torch.zeros(2 * n_build * fp * N_BINS, device=DEVICE)

        def lib_call():
            lib_out.zero_()
            lib_out.index_add_(0, idx, vals)

        t_lib = time_ms(torch, lib_call, REPS)
        del idx, vals
        for v in S.VARIANTS:
            what = f"(hist_floor {v}, n_build {n_build})"
            a = S.kernel_variant(bins_fp, node, ge, he, n_build, v)
            b = S.kernel_variant(bins_fp, node, ge, he, n_build, v)
            p = S.kernel_variant_plain(bins_fp, node, ge, he, n_build, v)
            torch.cuda.synchronize()
            require(torch.equal(a, p), f"kernel != plain on order-exact g/h "
                    f"{what}")
            require(torch.equal(a, b), f"not reproducible {what}")
            exact_b1 = None
            if v in ("shipped", "grpacc", "pack4", "pack8"):
                exact_b1 = torch.equal(a, ref)
                require(exact_b1, f"differs from build_histogram {what}")
            a = S.kernel_variant(bins_fp, node, g, h, n_build, v)
            b = S.kernel_variant(bins_fp, node, g, h, n_build, v)
            p = S.kernel_variant_plain(bins_fp, node, g, h, n_build, v)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(a).all()), f"non-finite {what}")
            require(torch.equal(a, b), f"not reproducible (general g/h) "
                    f"{what}")
            rel = floor_rel_err(torch, a, p, nh)
            tol = NODOT_TOL if v == "nodot" else FLOOR_TOL
            require(rel <= tol, f"off its plain version by {rel} (tolerance "
                    f"{tol}) on general g/h {what}")
            case = {"n_build": n_build, "lo": lo, "hi": hi, "A": A,
                    "out_shape": list(a.shape), "max_abs_err":
                    max_abs_err(torch, a, p), "rel_err": rel,
                    "tolerance": tol, "exact_plain": True,
                    "exact_build_histogram": exact_b1,
                    "device_ms": device_ms(torch, lambda: S.kernel_variant(
                        bins_fp, node, g, h, n_build, v), REPS),
                    "plain_ms": time_ms(torch, lambda: S.kernel_variant_plain(
                        bins_fp, node, g, h, n_build, v), 3),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_lib,
                    "product_flop_ms": product_flop_ms, "bytes": nbytes}
            cases[v].append(case)
        del ref, ge, he
        # the spike's main path: every variant and prod slope-timed, the
        # counts set to 0 just before and read just after
        for v in S.VARIANTS:
            S.kernel_variant.launches[v] = 0
        hist0 = H.hist_kernel.launches
        for v in ("prod",) + S.VARIANTS:
            spike[f"nb{n_build}_{v}_ms"] = S._run_level(
                bins, node, g, h, n_build, v) * 1e3
        launches = dict(S.kernel_variant.launches)
        require(H.hist_kernel.launches > hist0, "prod never launched B1")
        for v in S.VARIANTS:
            require(launches[v] > 0, f"hist_floor {v} was never launched "
                    "on the spike's path")
            case = cases[v][-1]
            case.update(ms=spike[f"nb{n_build}_{v}_ms"],
                        launches=launches[v],
                        prod_ms=spike[f"nb{n_build}_prod_ms"])
            emit({"phase": "hist_floor", "name": f"hist_floor_{v}",
                  "n": ROWS, "F": fp, **case})
        del bins, node, g, h
    emit({"phase": "hist_floor_spike", **spike})
    out = {}
    for v, cs in cases.items():
        out[f"hist_floor_{v}"] = {
            **summarize(cs, statistics.fmean(c["library_ms"] for c in cs)),
            "launches": sum(c["launches"] for c in cs),
            "library_call": "index_add_ (B1's yardstick)",
            "by_n_build": {str(c["n_build"]): {
                k: c[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "product_flop_ms", "library_ms",
                                  "launches", "rel_err")}
                for c in cs}}
    return out


def phase_bench(np):
    """``python -m dmlc_core_tpu_torch.bench`` at its defaults as a child
    process; its last line must be the final record of ``BENCH_ROUNDS``
    rounds that went through the kernels."""
    drop = set(LEVER_NAMES) | {"DMLC_TPU_ROUNDS_PER_DISPATCH",
                               "DMLC_TPU_BIN_BACKEND", "BENCH_FORCE_CPU"}
    env = {k: v for k, v in os.environ.items()
           if k not in drop and not k.startswith("BENCH_")}
    # the flagship size or a failure: no quiet drop to fewer rows
    env["BENCH_NO_FALLBACK"] = "1"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    require(res.returncode == 0 and lines,
            f"bench exited {res.returncode}: {res.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    require(rec.get("metric") == "histgbt_rounds_per_sec_per_chip",
            f"bench: wrong metric {rec.get('metric')}")
    require("error" not in rec and "terminated" not in rec,
            f"bench failed: {rec.get('error') or rec.get('terminated')}")
    require(rec.get("provisional") is False, "bench: last line provisional")
    require(rec.get("value", 0) > 0, f"bench: value {rec.get('value')}")
    require(rec.get("rounds_done") == BENCH_ROUNDS,
            f"bench: rounds_done {rec.get('rounds_done')}")
    require(rec.get("rows") == BENCH_ROWS and rec.get("features") == FEATURES
            and "fallback_from" not in rec,
            f"bench: ran {rec.get('rows')} x {rec.get('features')} "
            f"(fallback_from {rec.get('fallback_from')}), not the flagship's "
            f"{BENCH_ROWS} x {FEATURES}")
    launches = rec["kernel"]["launches"]
    require(launches["hist"] > 0 and launches["fused_round"] > 0,
            f"bench: the fit missed the kernels ({launches})")
    phases = {}
    for ln in lines:
        r = json.loads(ln)
        phases.setdefault(r["phase"], r["elapsed_s"])
    keys = ("value", "value_basis", "rounds_per_sec_median_chunk",
            "rounds_per_sec_best_chunk", "chunk_seconds_per_round",
            "seconds", "warmup_seconds", "warm_dispatch_seconds",
            "warmup_breakdown", "compile_seconds", "compile_cache",
            "bin_seconds", "time_to_first_tree", "kernel", "rows",
            "features", "rounds", "levers", "device_kind", "nvidia_smi",
            "hbm_gbps", "notes")
    emit({"phase": "bench", **{k: rec.get(k) for k in keys},
          "phase_elapsed_s": phases, "child_wall_seconds": wall})
    return rec


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.ops import attention as A
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.utils import device as device_mod

    t_start = time.perf_counter()
    # one tree per chunk in the fit phases: each tree's fetch times it
    os.environ["DMLC_TPU_ROUNDS_PER_DISPATCH"] = "1"
    smi = phase_device(torch, device_mod, _build)
    rates = card_rates(torch.cuda.get_device_name(0))
    tc_rate = tensor_rate(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    X, y = higgs_like(np, ROWS, FEATURES, 7)
    Xv, yv = higgs_like(np, 100_000, FEATURES, 8)
    C, cy = covtype_like(np, COVTYPE_ROWS, COVTYPE_SEED)
    Cv, cyv = covtype_like(np, 100_000, COVTYPE_SEED + 1)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "higgs_like": list(X.shape), "covtype_like": list(C.shape),
          "covtype_positive_share": float(cy.mean())})
    check_inf_binning(torch, np)
    kernels = phase_kernels(torch, H, rates)
    layout_kernels, mats = phase_kernels_layout(torch, np, H, rates, C, cy)
    kernels.update(layout_kernels)
    launches = {k: 0 for k in kernels}
    main_fit = phase_main(torch, np, H, rates, X, y, Xv, yv)
    lossguide_fit = phase_main_lossguide(torch, np, H, rates, X, y, Xv, yv)
    for counts in (main_fit[0]["launches"], lossguide_fit[0]["launches"],
                   phase_levers(torch, np, H, rates, C, cy, Cv, cyv)):
        for k, v in counts.items():
            launches[k] += v
    s = slice(0, CROSS_ROWS)
    phase_cross_device(np, {
        "depthwise": (X[s], y[s], {}),
        "1": (X[s], y[s], BENCH_LEVERS),
        "2a": (C[s], cy[s], BENCH_LEVERS),
        "2b": (C[s], cy[s], PACK_ONLY)})
    del C, cy
    for k, v in phase_data_parallel(torch, np, H, rates, X, y, Xv, yv,
                                    main_fit, lossguide_fit).items():
        launches[k] += v
    for k, v in launches.items():
        require(v > 0, f"{k} was never launched on the main paths")
    del X, y
    phase_deep_kernels(torch, H, rates, mats)
    floor = phase_hist_floor(torch, np, H, rates, tc_rate)
    attention = phase_attention_kernels(torch, A, rates, tc_rate)
    for k, v in phase_bert(torch, np, A, rates).items():
        require(v > 0, f"{k} was never launched on the BERT path")
        launches[k] = v
    kernels.update(attention)
    phase_bench(np)
    for k, v in floor.items():
        launches[k] = v.pop("launches")
    kernels.update(floor)
    hist_src = "dmlc_core_tpu_torch/ops/csrc/histogram.cu"
    attn_src = "dmlc_core_tpu_torch/ops/csrc/attention.cu"
    floor_src = "dmlc_core_tpu_torch/ops/csrc/hist_floor.cu"
    # the library kernel the JAX package calls (installed jax 0.9.0)
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    replaces = {"hist": "dmlc_core_tpu/ops/histogram.py:369",
                "fused_round": "dmlc_core_tpu/ops/histogram.py:531",
                "fused_descend": "dmlc_core_tpu/ops/histogram.py:485",
                "hist_layout": "dmlc_core_tpu/ops/histogram.py:450",
                "fused_round_layout": "dmlc_core_tpu/ops/histogram.py:587",
                "flash_fwd": f"{lib}:331",
                "flash_bwd_dkv": f"{lib}:796",
                "flash_bwd_dq": f"{lib}:1146",
                **{k: "scripts/spike_hist_floor.py:55" for k in floor}}
    extra = ("unfused_chain_ms", "chain_device_ms", "device_ms",
             "library_call", "library_device_ms", "by_n_build")
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": (attn_src if name in attention else
                    floor_src if name in floor else hist_src),
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         "held_against_plain": True,
         **{x: k[x] for x in extra if x in k}}
        for name, k in kernels.items()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
