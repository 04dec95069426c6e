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
3b. missing — NaN-as-missing mode on a NaN copy of the HIGGS-like rows
   (:func:`nan_copy`: 10% of each of features 1.. from seed 9, and feature
   0 wherever it exceeds 1.0, so that both directions are learned): the
   device route's cuts and ``apply_bins_missing`` held bit-equal to the
   host route's (``compute_cuts`` on the CPU, ``_host_bin_t``) on the
   first 2M of those rows;
   ``descend_kernel``'s direction mode against ``descend_plain`` at n_prev
   1..16 on those bins (bit-equal, both table forms, timed beside its
   9-bytes-a-row bound); then the depth-wise fit of phase 4 on them, with
   the checks of phase 4: missing mode, both directions learned, ``hist``
   (B1) at every level and the direction-aware descend at every level and
   the final one, no fused round;
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
6b. eval_set — ``fit(eval_set=, early_stopping_rounds=2)`` with
   ``eval_metric="auc"``, a score a tree, on the NaN rows (100k NaN
   held-out rows as the eval set): ``eval_history``, ``best_iteration``
   and ``predict``'s use of it; then on a 100k-row slice on the GPU and on
   the CPU, their ``eval_history`` within rtol 1e-6;
6c. softmax — ``multi:softmax`` with covtype's 7 cover types at UCI
   Covertype's class counts on the covtype-schema rows (581,012 × 54),
   depth 6, 256 bins, 5 rounds, depth-wise then lossguide 16: ``hist``
   and ``fused_round`` launched 7× a round's counts (7 + 35 depth-wise),
   trees stacked ``[7, depth, half]``, held-out merror below the majority
   class's share, ``predict_proba`` rows summing to 1; the depth-wise
   fit of a 100k-row slice on the card and on the CPU: equal files;
6d. resume — configuration 1 on the HIGGS-like rows: 3 trees, then
   ``fit_device(resume=True)`` for 2 more, writes phase 5's file; the
   3-tree ensemble replayed on the handle (``descend_kernel``, 18
   launches) equals the carried margins bit for bit; ``load_model`` of a
   saved 3-tree file, then ``fit``, writes the same file;
6e. sampling — ``subsample=0.8``, ``colsample_bytree=0.8``, seed 3, the
   depth-wise fit on the HIGGS-like rows: each round's keep and feature
   masks on the card equal the CPU's at 10M rows, the draw timed per
   round, a sampled 3 + 2 resume writes the uninterrupted file, and the
   cuda and cpu files of a 100k-row slice are equal;
6f. monotone — +1 on feature 2 and −1 on feature 3 (the label rule's
   signs), depth-wise on the HIGGS-like rows: the margin along a
   256-point sweep of each constrained feature moves with its sign for
   1000 held-out rows; equal cuda and cpu files of a 100k-row slice;
6g. external — ``fit_external`` on the HIGGS-like rows as 153
   ``ArrayRowIter`` pages of 65,536 rows: (a) the default route (cached
   under the 6 GiB budget), (b) the chunked route with the budget set for
   4 chunks (B1 and ``descend_kernel`` per chunk per level, 24 each a
   tree; the bin bytes uploaded a tree), (c) (b) with ``subsample=0.8``,
   ``colsample_bytree=0.8``: the card's sketch cuts equal the CPU's bit
   for bit, (a), (b) and the in-core ``fit(X, y, cuts=)`` write one file,
   (c) on a 200k-row slice (4 chunks) writes the CPU's file (the numpy
   draws, uploads and feature masks on both), ``predict_iter`` over
   the pages equals ``predict``, and a 200k-row slice written as libsvm
   text and read back through ``RowBlockIter.create("…#cache")`` trains
   the slice's ``ArrayRowIter`` file;
6g2. ingest_iter — ``HistGBT.make_device_data_iter`` over 6g's pages
   (densified page by page): the sketch pass and the slabs through
   ``DeviceFeed`` binned on the card; its bins, labels and weights
   ``torch.equal`` to ``make_device_data(X, y, cuts=same)``'s, one file
   from a 5-tree ``fit_device`` of each handle; both passes' seconds, each
   handle's peak device memory and the feed's stall fraction;
6g3. infeed — the port bench's infeed smoke (24 ``[2048, 128]`` batches
   through ``DeviceFeed(depth=2)``): its stall fraction;
6h. ranking — ``rank:pairwise``, ``rank:ndcg`` and ``rank:map`` with
   ``fit(qid=)`` on MSLR-WEB10K-schema rows (:func:`mslr_like`: 136
   features, 10,000 queries, 1,200,192 docs), 5 rounds each: 1 ``hist``
   + 5 ``fused_round`` a tree, the objective's time a round, held-out
   NDCG@10 on 1,000 further queries above a random order's, and equal
   card and CPU files on a 200-query slice; ``hist`` at the root and
   ``fused_round`` at n_prev 1..16 against their plain versions on the
   rank fit's own padded matrix (``[136, 2,720,000]``, its accumulation
   plan) with ``rank:ndcg`` g/h of seeded margins;
6i. introspect — ``predict_leaf`` on the card equal to the CPU's, and
   ``dump_model`` / ``feature_importances`` equal, for phase 4's model
   and 6c's depth-wise softmax model;
7. cross-device — depth-wise, 1, 2a, 2b and missing on 100k-row slices, on
   the GPU and on the CPU (plain versions): every tree bit-identical, and
   the model files;
8. data_parallel — the data-parallel fit on the HIGGS-like rows: (a) a
   NCCL group of one on this card, ``DMLC_HIST_BLOCKS=8`` and
   ``DMLC_TPU_FUSED_DESCEND=1``: 5 ``fused_descend`` and no
   ``fused_round`` per tree, the model file of phase 4; (b) two ranks
   sharing this card under gloo (NCCL refuses two ranks on one GPU), 5M
   rows each, depth-wise and configuration 1 with
   ``DMLC_TPU_FUSED_DESCEND=1``: each rank's model file that of phase 4
   / 5; (c) the int8 sync (``DMLC_HIST_QUANT=1``) on the two ranks: the
   held-out accuracy floor of phase 4, its margins beside (b)'s exact
   ones; and the missing slice of phase 7 on the two ranks: each rank's
   model file that of the 1-process fit on the card; and 6c's depth-wise
   softmax fit on the two ranks (7 ``hist`` and 35 ``fused_descend`` a
   round each): each rank's file that of the 1-process fit.  The ranks
   are child processes with a time limit;
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
12b. sparse — ``SparseHistGBT`` at ``tools/bench_sparse.py``'s defaults
    (100k rows × F = 100k at density 0.005, ~50M entries, 20 rounds, 32
    bins, depth 6; its warm-up fits first): rounds/s, predict rows/s,
    train accuracy above 0.9, one round's device time by group
    (histogram, routing, split scan) from ``torch.profiler``; on the first
    5,000 rows (3 trees) the card's model file equal to the CPU's, and two
    gloo ranks sharing the card, each with half the slice and its cuts,
    writing that file.  The sparse engine is torch array code (the JAX
    package's is XLA array code): no hand kernel, so no launch count;
13. bench — ``python -m dmlc_core_tpu_torch.bench`` as a child process at
    its defaults (10M × 28, 100 rounds after 10 warmup rounds, the
    flagship's levers, host binning), with a time limit: its last line
    must be the final ``histgbt_rounds_per_sec_per_chip`` record of 100
    rounds, with kernel launches, and its headline fields are emitted;
14. the ``kernels`` line (launches summed over phases 3b-6h and 8, phase
    11's for attention, phase 12's timing pass for the B5 variants;
    ``descend_dir`` is ``descend_kernel``'s direction mode, B2's descend
    on the missing path), then
    the card's name and power limit, then the ``ok`` line.

The fit phases (3b-8) run with ``DMLC_TPU_ROUNDS_PER_DISPATCH=1``: each
tree is its own chunk, fetched on its own, so ``last_tree_times`` stay
per tree and the steady rate can leave the first tree out.
"""

from __future__ import annotations

import contextlib
import hashlib
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
#: launches of torch's spin kernel (``torch.cuda._sleep``, a few µs each)
#: that open and close each profiled window of ``device_ms``: they take
#: the records the tracer loses at a window's start
TRACE_PAD = 256
TRACE_PAD_CYCLES = 1000
TRACE_PAD_KERNEL = "spin_kernel"
#: the missing phase: NaN set from this seed (the held-out rows' from the
#: next) in this share of each of features 1.., and in feature 0 wherever
#: it exceeds MISS_CUT, so that both directions are learned; n_prev of the
#: descend checks; the held-out accuracy floor of its fit (a CPU fit of
#: 200k rows scores 0.80, the same rows without NaN 0.85)
MISS_SEED = 9
MISS_SHARE = 0.1
MISS_CUT = 1.0
MISS_N_PREV = (1, 2, 4, 8, 16)
#: rows of the device-route vs host-route binning check (all 10M rows
#: through PR 11; the host route's cuts take 73-88 s there)
MISS_HOST_ROWS = 2_000_000
MISS_MIN_ACC = 0.75
#: the eval_set phase: rounds, early stopping, and the cuda-vs-cpu
#: agreement of eval_history's scores
EVAL_TREES = 10
EVAL_EARLY_STOP = 2
EVAL_RTOL = 1e-6
#: the softmax phase: covtype's 7 cover types at UCI Covertype's class
#: counts (XGBoost's demo/gpu_acceleration/cover_type.py trains
#: multi:softmax on them)
COVER_TYPE_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
SOFTMAX = {"objective": "multi:softmax", "num_class": len(COVER_TYPE_COUNTS)}
#: the class column whose g/h the softmax kernel checks take (cover type
#: 4, the fewest rows)
SOFTMAX_CHECK_CLASS = 3
#: the resume phase: trees of the first leg of 3 + 2
RESUME_FIRST = 3
#: the sampling phase's rates and seed, and the CUDA-event timings of
#: one round's draw
SAMPLING = {"subsample": 0.8, "colsample_bytree": 0.8, "seed": 3}
DRAW_REPS = 5
#: the monotone phase: +1 on feature 2 and −1 on feature 3, the signs of
#: the label rule's terms (+0.5·x2, −0.8·x3·(x4 > 0)); each constrained
#: feature swept over this many points for this many probe rows
MONOTONE = (0, 0, 1, -1) + (0,) * (FEATURES - 4)
SWEEP_POINTS = 256
SWEEP_PROBES = 1000
#: the bench child's time limit (s) and its rounds (the bench's default)
# ranking: MSLR-WEB10K's published schema (Microsoft Learning to Rank
# datasets, Qin & Liu 2013: 136 features, 10,000 queries, 1,200,192 docs,
# relevance 0-4 with most docs at 0); features, labels and query lengths
# from a seed, lengths ~ N(120, RANK_LEN_SD) (at least 1) adjusted to the
# published total
RANK_QUERIES = 10_000
RANK_DOCS = 1_200_192
RANK_FEATURES = 136
RANK_LEN_SD = 30.0
RANK_LABEL_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)
RANK_SEED = 31
RANK_OBJECTIVES = ("rank:pairwise", "rank:ndcg", "rank:map")
RANK_HELDOUT = 1_000
RANK_CROSS_QUERIES = 200
RANK_OBJ_REPS = 5
#: the objective whose g/h hold the kernels on the rank fit's matrix
RANK_CHECK_OBJECTIVE = "rank:ndcg"
# external: the HIGGS-like rows as ArrayRowIter pages
EXT_PAGE_ROWS = 65_536
EXT_CHUNKS = 4
EXT_SAMPLING = {"subsample": 0.8, "colsample_bytree": 0.8, "seed": 3}
EXT_SLICE = 200_000
EXT_BUDGET = "DMLC_TPU_EXTERNAL_DEVICE_BUDGET"

# sparse: tools/bench_sparse.py's defaults (100k rows, F = 100k, density
# 0.005, 20 rounds, 32 bins, depth 6); the card-vs-CPU and 2-rank checks
# on the first SPARSE_SLICE rows, SPARSE_SLICE_TREES trees
SPARSE_MIN_ACC = 0.9
SPARSE_SLICE = 5_000
SPARSE_SLICE_TREES = 3
SPARSE_RANKS = 2
SPARSE_PROFILE_TREES = 3

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


def device_ms(torch, fn, reps: int, attempts: int = 5) -> float:
    """Device time of one call of ``fn``: each CUDA kernel's mean time in
    a ``torch.profiler`` trace of ``reps`` calls, times its launches per
    call, summed (no host gap counts, unlike a CUDA-event window around a
    host-heavy call).

    The tracer loses a window's first records, a number that grows as
    the process runs, and can deliver records late into the next window.
    So ``TRACE_PAD`` launches of torch's spin kernel open and
    close each window and are left out by name; a kernel's launches per
    call are its count over ``reps`` rounded half up, and a kernel with
    fewer than half a launch a call is a stray of another window and
    left out; an empty window first takes any late records.  Up to
    ``attempts`` traces, each empty one reported on stderr with the
    window's records, then the measurement fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(TRACE_PAD_CYCLES)
            for _ in range(reps):
                fn()
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(TRACE_PAD_CYCLES)
            torch.cuda.synchronize()
        total = 0.0
        seen = []
        for evt in prof.key_averages():
            if TRACE_PAD_KERNEL in evt.key:
                continue
            t = getattr(evt, "device_time_total", None)
            t = evt.cuda_time_total if t is None else t
            per_call = int(evt.count / reps + 0.5)
            seen.append((evt.key[:40], evt.count, t))
            if t > 0 and per_call > 0:
                total += t / evt.count * per_call
        if total > 0:
            return total / 1e3
        print(json.dumps({"device_ms_empty_trace": attempt, "reps": reps,
                          "records": seen}), file=sys.stderr, flush=True)
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


def covtype_like(np, n, seed, classes=2):
    """Seeded synthetic rows with the schema of UCI Covertype (LIBSVM
    ``covtype.binary``): 10 integer-valued columns in the documented
    ranges (elevation 1859–3858, aspect 0–360, slope 0–66, distances to
    hydrology (horizontal ≥ 0, vertical −173–601), roads and fire points
    ≥ 0, hillshades 0–254); 4 one-hot wilderness columns at covtype's
    counts (scaled to ``n``); 40 one-hot soil columns from a Zipf(1.3)
    draw independent of wilderness; a nonlinear label, half positive —
    or with ``classes=7`` the cover type, the score's buckets at
    covtype's class counts (scaled to ``n``)."""
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
    if classes == 2:
        return X, (z < np.median(z)).astype(np.float32)
    share = np.cumsum(COVER_TYPE_COUNTS)[:-1] / sum(COVER_TYPE_COUNTS)
    return X, np.digitize(z, np.quantile(z, share)).astype(np.float32)


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
    H.descend_kernel.launches = 0
    H.descend_kernel.dir_launches = 0


def read_counts(H):
    return {"hist": H.hist_kernel.launches,
            "fused_round": H.fused_round_kernel.launches,
            "hist_layout": H.hist_kernel.layout_launches,
            "fused_round_layout": H.fused_round_kernel.layout_launches,
            "fused_descend": H.fused_descend_kernel.launches,
            "descend_dir": H.descend_kernel.dir_launches}


def fit_path(torch, np, H, X, y, Xv, yv, env, min_acc):
    """Drive one path: ``HistGBT.fit`` under ``env`` with the launch
    counts set to 0 just before and read just after, train logloss after
    every round (replayed from the trees), held-out accuracy, and
    ``save_model`` → ``load_model`` giving the same predictions."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.models.histgbt import _predict_trees

    model = HistGBT(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS,
                    device=DEVICE)
    with levers(env):
        zero_counts(H)
        t0 = time.perf_counter()
        model.fit(X, y)
        wall_s = time.perf_counter() - t0
        launches = read_counts(H)
    n = len(X)
    bins_t = model._bin_matrix(X)
    y_d = torch.from_numpy(y).to(DEVICE)
    stacked = model._stacked_trees(model.trees)
    dirs = stacked.get("dir")
    margin = torch.zeros(n, device=DEVICE)
    losses = []
    for t in range(TREES):
        margin = _predict_trees(bins_t, stacked["feat"][t:t + 1],
                                stacked["thr"][t:t + 1],
                                stacked["leaf"][t:t + 1], MAX_DEPTH, margin,
                                None if dirs is None else dirs[t:t + 1],
                                model._miss_bin())
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
             "holdout_accuracy": acc, "launches": launches,
             "missing": model._missing}
    return model, stats, model_bytes


def require_launches(launches, want, what):
    for k, v in want.items():
        require(launches[k] == v,
                f"{what}: {k} launched {launches[k]} times, want {v}")


def phase_main(torch, np, H, rates, X, y, Xv, yv):
    """The depth-wise fit at the flagship's shapes (default levers)."""
    model, stats, model_bytes = fit_path(torch, np, H, X, y, Xv, yv, {},
                                         0.6)
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
    return stats, model_bytes, model


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
    on the CPU (plain versions): every tree bit-identical, and the model
    files.  Returns each configuration's file."""
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    out = {}
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
        require(gpu._missing == cpu._missing == np.isnan(X).any(),
                f"{name}: missing mode differs between cuda and cpu")
        for i, (a, b) in enumerate(zip(gpu.trees, cpu.trees)):
            require(list(a) == list(b),
                    f"{name}: tree {i}'s arrays differ between cuda and cpu")
            for key in a:
                require(a[key].tobytes() == b[key].tobytes(),
                        f"{name}: tree {i} {key} differs between cuda and "
                        "cpu")
        files = []
        for m in (gpu, cpu):
            with tempfile.TemporaryDirectory() as d:
                m.save_model(os.path.join(d, "model.bin"))
                with open(os.path.join(d, "model.bin"), "rb") as f:
                    files.append(f.read())
        require(files[0] == files[1],
                f"{name}: cuda and cpu model files differ")
        pg, pc = gpu.predict(X), cpu.predict(X)
        require(np.array_equal(pg, pc),
                f"{name}: cuda and cpu predictions differ")
        emit({"phase": "cross_device", "config": name, "rows": len(X),
              "trees": TREES, "levers": env, "missing": gpu._missing,
              "layout_phys_rows": (None if gpu._bin_layout is None
                                   else gpu._bin_layout.phys_rows),
              "identical_trees": len(gpu.trees),
              "identical_model_files": True,
              "max_abs_pred_diff": float(np.abs(pg - pc).max())})
        out[name] = files[0]
    return out


def nan_copy(np, X, seed):
    """``X`` with NaN (missing) as the missing phase sets it: ``MISS_SHARE``
    of each of features 1.. at random, from ``seed``, and feature 0
    wherever it exceeds ``MISS_CUT``."""
    rng = np.random.default_rng(seed)
    Xm = X.copy()
    for f in range(1, X.shape[1]):
        Xm[rng.random(len(X)) < MISS_SHARE, f] = np.nan
    Xm[X[:, 0] > MISS_CUT, 0] = np.nan
    return Xm


def check_descend_dir(torch, H, bins, masked, gen, n_prev, miss_bin, rates):
    """``descend_kernel``'s direction mode at one level (``n_prev``
    parents, random learned directions) against ``descend_plain``, twice
    over, in both table forms; every row of the NaN bin follows its node's
    direction; then timed beside its bound (the bin byte, the node id in
    and out: 9 bytes a row, plus the tables)."""
    F, n = bins.shape
    dev = bins.device
    nd = torch.randint(0, n_prev, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    nd = torch.where(masked, -1, nd).to(torch.int32)
    feat = torch.randint(0, F, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)
    thr = torch.randint(0, miss_bin, (n_prev,), dtype=torch.int32,
                        device=dev, generator=gen)
    dirv = torch.randint(0, 2, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)

    def run(f_, t_, d_, by_node):
        return H.descend_kernel(bins, nd, f_, t_, by_node, None, d_,
                                miss_bin)

    a = run(feat, thr, dirv, True)
    b = run(feat, thr, dirv, True)
    c = H.descend_plain(bins, nd, feat, thr, True, None, dirv, miss_bin)
    torch.cuda.synchronize()
    what = f"(n_prev={n_prev})"
    require(torch.equal(a, c), f"descend_kernel (direction) != plain {what}")
    require(torch.equal(a, b), f"descend_kernel not reproducible {what}")
    safe = nd.clamp(min=0).long()
    r = run(feat[safe], thr[safe], dirv[safe], False)
    require(torch.equal(r, a), f"descend_kernel per-row form differs {what}")
    row_bin = bins[feat[safe], torch.arange(n, device=dev)]
    miss = (nd >= 0) & (row_bin == miss_bin)
    require(bool(miss.any()) and torch.equal(
        (a[miss] % 2 == 1), dirv[safe][miss] == 0),
        f"NaN rows do not follow their direction {what}")
    nbytes = n + 4 * n + 4 * n + 12 * n_prev
    b_ms, b_by = bound(nbytes, n, rates)
    return {
        "n_prev": n_prev, "missing_rows": int(miss.sum()),
        "missing_right": int((a[miss] % 2).sum()),
        "ms": time_ms(torch, lambda: run(feat, thr, dirv, True), REPS),
        "plain_ms": time_ms(torch, lambda: H.descend_plain(
            bins, nd, feat, thr, True, None, dirv, miss_bin),
            max(3, REPS // 3)),
        # a short kernel: a long window, past the tracer's dropped first
        # records
        "device_ms": device_ms(torch, lambda: run(feat, thr, dirv, True),
                               10 * REPS),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max_abs_err(torch, a, c), "bytes": nbytes}


def live_dirs(np, trees):
    """The learned directions of every split node of ``trees``."""
    return np.concatenate([np.asarray(t["dir"])[lv, :1 << lv]
                           for t in trees for lv in range(MAX_DEPTH)])


def phase_missing(torch, np, H, rates, X, y, Xv, yv):
    """NaN-as-missing mode at the flagship's shapes: the NaN copies of the
    HIGGS-like rows; the device route's cuts and bins against the host
    route's on the first ``MISS_HOST_ROWS`` rows; ``descend_kernel``'s direction mode at ``MISS_N_PREV``
    against its plain version on those bins; the depth-wise fit (B1 at
    every level, the direction-aware descend, no fused round).  Returns
    the NaN rows, the ``kernels`` entry of the direction mode and the
    fit's launches."""
    from dmlc_core_tpu_torch.models.gbt_split import _host_bin_t
    from dmlc_core_tpu_torch.ops.quantile import (apply_bins_missing,
                                                  compute_cuts)

    t0 = time.perf_counter()
    Xm = nan_copy(np, X, MISS_SEED)
    Xmv = nan_copy(np, Xv, MISS_SEED + 1)
    datagen_s = time.perf_counter() - t0
    miss_bin = N_BINS - 1
    Xd = torch.from_numpy(Xm).to(DEVICE)
    t0 = time.perf_counter()
    cuts = compute_cuts(Xd, N_BINS - 1, missing=True)
    bins = apply_bins_missing(Xd, cuts, miss_bin)
    torch.cuda.synchronize()
    device_bin_s = time.perf_counter() - t0
    require(cuts.shape == (FEATURES, N_BINS - 2), "missing: cut width")
    require(bool(torch.isfinite(cuts).all()), "missing: cuts not finite")
    # the host route (73-88 s at 10M rows on one core) against the card's
    # on the first MISS_HOST_ROWS rows
    s = slice(0, MISS_HOST_ROWS)
    cuts_s = compute_cuts(Xd[s], N_BINS - 1, missing=True)
    bins_s = apply_bins_missing(Xd[s], cuts_s, miss_bin).cpu().numpy()
    del Xd
    t0 = time.perf_counter()
    cuts_h = compute_cuts(torch.from_numpy(Xm[s]), N_BINS - 1,
                          missing=True).numpy()
    host = _host_bin_t(Xm[s], cuts_h, missing=True)
    host_bin_s = time.perf_counter() - t0
    require(np.array_equal(cuts_s.cpu().numpy().view(np.uint32),
                           cuts_h.view(np.uint32)),
            "missing: device-route cuts differ from the host route's")
    differ = (bins_s != host).sum(1)
    require(bins.dtype == torch.uint8 and not differ.any(),
            f"missing: device bins differ from _host_bin_t on "
            f"{differ.tolist()} rows")
    del host, bins_s
    bins_np = bins.cpu().numpy()
    nan_rows = (bins_np == miss_bin).sum(1)
    require(np.array_equal(nan_rows, np.isnan(Xm).sum(0)),
            "missing: NaN rows not in the reserved bin")
    del bins_np
    emit({"phase": "missing_binning", "rows": ROWS, "n_bins": N_BINS,
          "miss_bin": miss_bin, "nan_rows_per_feature": nan_rows.tolist(),
          "datagen_seconds": datagen_s, "device_bin_seconds": device_bin_s,
          "host_check_rows": MISS_HOST_ROWS,
          "host_bin_seconds": host_bin_s, "rows_differing": 0})
    _, _, _, masked, gen, _, _ = kernel_inputs(torch, H, bins)
    cases = []
    for n_prev in MISS_N_PREV:
        case = check_descend_dir(torch, H, bins, masked, gen, n_prev,
                                 miss_bin, rates)
        cases.append(case)
        emit({"phase": "kernel", "name": "descend_dir", "n": ROWS,
              "F": FEATURES, "B": N_BINS, **case})
    right = sum(c["missing_right"] for c in cases)
    require(0 < right < sum(c["missing_rows"] for c in cases),
            "missing: the direction checks never took both directions")
    entry = summarize(cases)
    del bins, masked
    model, stats, model_bytes = fit_path(torch, np, H, Xm, y, Xmv, yv, {},
                                         MISS_MIN_ACC)
    require(model._missing and "dir" in model.trees[0],
            "missing: the fit is not in missing mode")
    dirs = live_dirs(np, model.trees)
    require(set(dirs.tolist()) == {0, 1},
            f"missing: directions learned {sorted(set(dirs.tolist()))}")
    require_launches(stats["launches"], {
        "hist": MAX_DEPTH * TREES, "fused_round": 0, "hist_layout": 0,
        "fused_round_layout": 0, "fused_descend": 0,
        "descend_dir": MAX_DEPTH * TREES}, "missing")
    emit({"phase": "missing", **stats,
          "directions": {"left": int((dirs == 1).sum()),
                         "right": int((dirs == 0).sum())},
          "descend_dir_ms": entry["ms"],
          "descend_dir_device_ms": entry["device_ms"],
          "descend_dir_bound_ms": entry["bound_ms"]})
    return Xm, Xmv, entry, stats


def phase_eval_set(torch, np, H, X, y, Xv, yv):
    """``fit(eval_set=, early_stopping_rounds=)`` with ``eval_metric=auc``
    and chunks of one tree: on the NaN rows at full size on the card, then
    on a ``CROSS_ROWS`` slice on the card and on the CPU, whose
    ``eval_history`` must agree.  Returns the full fit's launches."""
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(n_trees=EVAL_TREES, max_depth=MAX_DEPTH, n_bins=N_BINS,
              eval_metric="auc")

    def fit(device, Xt, yt):
        m = HistGBT(device=device, **kw)
        m.fit(Xt, yt, eval_set=(Xv, yv),
              early_stopping_rounds=EVAL_EARLY_STOP)
        rounds = [r for r, _ in m.eval_history]
        require(m._missing and rounds == list(range(1, len(m.trees) + 1)),
                f"eval_set: rounds {rounds} for {len(m.trees)} trees")
        scores = [sc for _, sc in m.eval_history]
        require(all(0.5 < sc <= 1.0 for sc in scores),
                f"eval_set: auc {scores}")
        best = max(range(len(scores)), key=lambda i: (scores[i], -i))
        require(m.best_iteration == best and m.best_score == scores[best],
                f"eval_set: best {m.best_iteration} of {scores}")
        return m

    zero_counts(H)
    t0 = time.perf_counter()
    full = fit(DEVICE, X, y)
    wall_s = time.perf_counter() - t0
    launches = read_counts(H)
    require(launches["hist"] > 0 and launches["descend_dir"] > 0
            and launches["fused_round"] == 0,
            f"eval_set: the fit missed the missing path ({launches})")
    pv = full.predict(Xv, output_margin=True)
    require(np.array_equal(pv, full.predict(
        Xv, output_margin=True, n_trees=full.best_iteration + 1)),
        "eval_set: predict ignores best_iteration")
    s = slice(0, CROSS_ROWS)
    gpu = fit(DEVICE, X[s], y[s])
    cpu = fit("cpu", X[s], y[s])
    rg, rc = ([r for r, _ in m.eval_history] for m in (gpu, cpu))
    sg, sc_ = (np.array([v for _, v in m.eval_history]) for m in (gpu, cpu))
    require(rg == rc and np.allclose(sg, sc_, rtol=EVAL_RTOL, atol=0),
            f"eval_set: cuda {gpu.eval_history} vs cpu {cpu.eval_history}")
    require(gpu.best_iteration == cpu.best_iteration,
            "eval_set: best_iteration differs between cuda and cpu")
    emit({"phase": "eval_set", "rows": len(X), "eval_rows": len(Xv),
          "metric": full.eval_metric_name, "trees": len(full.trees),
          "eval_history": full.eval_history,
          "best_iteration": full.best_iteration,
          "best_score": full.best_score,
          "early_stopped_at": (len(full.trees)
                               if len(full.trees) < EVAL_TREES else None),
          "fit_seconds": full.last_fit_seconds, "fit_wall_seconds": wall_s,
          "launches": launches,
          "slice_rows": CROSS_ROWS,
          "slice_eval_history_cuda": gpu.eval_history,
          "slice_eval_history_cpu": cpu.eval_history,
          "slice_identical_scores": bool(np.array_equal(sg, sc_)),
          "slice_max_rel_diff": float(np.max(np.abs(sg - sc_) / sc_))})
    return launches


# ---------------------------------------------------------------------------
# the rest of HistGBT's surface: multi:softmax, continued training,
# sampling, monotone constraints, introspection
# ---------------------------------------------------------------------------

def model_bytes_of(model, n_trees=None) -> bytes:
    """``save_model``'s bytes (with ``n_trees`` set first, as a continued
    model's param says the total)."""
    if n_trees is not None:
        model.param.n_trees = n_trees
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.bin")
        model.save_model(path)
        with open(path, "rb") as f:
            return f.read()


def path_kernels(torch, H, rates, shape, bins, g, h, gen, lossguide):
    """``hist`` at the root and ``fused_round`` at each depth-wise level's
    ``n_prev`` (and, with ``lossguide``, at a lossguide expansion:
    ``n_prev`` 1 over about half the rows, the rest node −1) against
    their plain versions on a fit's own matrix ``bins`` with its g/h, so
    with that matrix's accumulation plan.  Returns the largest error of
    each kernel."""
    n = bins.shape[1]
    kg, kh = H.hist_scales(g, h)
    none = torch.zeros(n, dtype=torch.bool, device=bins.device)
    shape = {**shape, "part": "kernels", "n": n, "F": bins.shape[0],
             "B": N_BINS}
    case = check_hist(torch, H, bins, g, h, none, kg, kh, rates)
    emit({**shape, "name": "hist", "n_nodes": 1, **case})
    errs = {"hist": case["max_abs_err"], "fused_round": 0.0}
    levels = [("depthwise", 1 << (lv - 1), none)
              for lv in range(1, MAX_DEPTH)]
    if lossguide:
        levels.append(("lossguide", 1, torch.rand(n, device=bins.device,
                                                  generator=gen) < 0.5))
    for policy, n_prev, masked in levels:
        case = check_fused_round(torch, H, bins, g, h, masked, gen, n_prev,
                                 kg, kh, rates)
        emit({**shape, "name": "fused_round", "policy": policy, **case})
        errs["fused_round"] = max(errs["fused_round"], case["max_abs_err"])
    return errs


def softmax_kernels(torch, H, rates, C, cy):
    """:func:`path_kernels` on the softmax fit's own matrix — the plain
    covtype ``[54, 581012]`` it bins (no layout fires) — with one class
    column's softmax g/h of seeded ``[n, 7]`` margins, lossguide's
    expansion included."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.models.gbt_objectives import OBJECTIVES

    dd = HistGBT(max_depth=MAX_DEPTH, n_bins=N_BINS, device=DEVICE,
                 **SOFTMAX).make_device_data(C, cy)
    require(dd["layout"] is None, "softmax: a layout fired on its matrix")
    bins = dd["bins_t"]
    gen = torch.Generator(device=bins.device)
    gen.manual_seed(SEED)
    margins = 0.5 * torch.randn((bins.shape[1], SOFTMAX["num_class"]),
                                device=bins.device, generator=gen)
    g, h = OBJECTIVES[SOFTMAX["objective"]].grad_hess(margins, dd["y_d"])
    del dd, margins
    return path_kernels(torch, H, rates, {"phase": "softmax",
                                          "class": SOFTMAX_CHECK_CLASS},
                        bins, g[:, SOFTMAX_CHECK_CLASS].contiguous(),
                        h[:, SOFTMAX_CHECK_CLASS].contiguous(), gen, True)


def ranking_kernels(torch, H, rates, X, y, qid):
    """:func:`path_kernels` on the rank fit's own matrix — the regrouped
    MSLR-like rows, pad docs included (zero features, weight 0) — with
    ``RANK_CHECK_OBJECTIVE``'s g/h of seeded margins times the weights,
    as the boosting loop gives them to the kernels."""
    from dmlc_core_tpu_torch import HistGBT

    model = HistGBT(max_depth=MAX_DEPTH, n_bins=N_BINS, device=DEVICE,
                    objective=RANK_CHECK_OBJECTIVE)
    Xp, yp, wp = model._regroup_ranking(X, y, qid, None)
    dd = model.make_device_data(Xp, yp, weight=wp)
    del Xp
    require(dd["layout"] is None, "ranking: a layout fired on its matrix")
    bins = dd["bins_t"]
    gen = torch.Generator(device=bins.device)
    gen.manual_seed(SEED)
    margins = 0.5 * torch.randn(bins.shape[1], device=bins.device,
                                generator=gen)
    g, h = model._obj.grad_hess(margins, dd["y_d"])
    g, h = g * dd["w_d"], h * dd["w_d"]
    del dd, margins
    return path_kernels(torch, H, rates, {
        "phase": "ranking", "objective": RANK_CHECK_OBJECTIVE,
        "G": model._obj.G, "pad_share": float(1.0 - wp.mean())},
        bins, g, h, gen, False)


def phase_softmax(torch, np, H, rates, smi, C, cy, Cv, cyv):
    """``multi:softmax`` with covtype's 7 classes on its schema and row
    count, depth-wise then lossguide 16: ``hist`` and ``fused_round`` 7×
    a round's counts, held-out merror below the majority class's share,
    probabilities of each row summing to 1; the two kernels against
    their plain versions on this fit's matrix (:func:`softmax_kernels`);
    then the depth-wise fit on a ``CROSS_ROWS`` slice on the card and on
    the CPU, whose files must be equal.  Returns the launches, the
    depth-wise model, its file and the kernels' largest errors."""
    from dmlc_core_tpu_torch import HistGBT

    K = SOFTMAX["num_class"]
    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS, **SOFTMAX)
    majority = 1.0 - float(np.bincount(cyv.astype(np.int64)).max()
                           / len(cyv))
    total, out = None, {}
    for policy, env, builds in (("depthwise", {}, MAX_DEPTH - 1),
                                ("lossguide", LEVERS_OFF, MAX_LEAVES - 1)):
        model = HistGBT(device=DEVICE, **kw)
        with levers(env):
            zero_counts(H)
            t0 = time.perf_counter()
            model.fit(C, cy)
            wall_s = time.perf_counter() - t0
            launches = read_counts(H)
        require_launches(launches, {
            "hist": K * TREES, "fused_round": K * builds * TREES,
            "hist_layout": 0, "fused_round_layout": 0, "fused_descend": 0,
            "descend_dir": 0}, f"softmax {policy}")
        total = (dict(launches) if total is None else
                 {k: total[k] + v for k, v in launches.items()})
        require(len(model.trees) == TREES and model.trees[0]["feat"].shape
                == (K, MAX_DEPTH, 1 << (MAX_DEPTH - 1)),
                f"softmax {policy}: trees not stacked [K, depth, half]")
        margins = model.train_margins()
        require(margins.shape == (len(C), K) and np.isfinite(margins).all(),
                f"softmax {policy}: training margins malformed")
        pred = model.predict(Cv)
        proba = model.predict_proba(Cv)
        require(proba.shape == (len(Cv), K)
                and np.allclose(proba.sum(1), 1.0, atol=1e-5)
                and np.array_equal(pred, proba.argmax(1).astype(np.float32)),
                f"softmax {policy}: predict_proba malformed")
        merror = float((pred != cyv).mean())
        require(merror < majority, f"softmax {policy}: held-out merror "
                f"{merror} not below the majority share {majority}")
        out[policy] = model
        emit({"phase": "softmax", "policy": policy, "card": smi,
              "rows": len(C), "features": C.shape[1], "classes": K,
              "trees": TREES, "max_depth": MAX_DEPTH, "levers": env,
              "launches": launches,
              "launches_per_round": {k: v / TREES
                                     for k, v in launches.items()},
              "fit_seconds": model.last_fit_seconds,
              "fit_wall_seconds": wall_s,
              "rounds_per_sec": TREES / model.last_fit_seconds,
              "steady_rounds_per_sec": steady_rounds_per_sec(
                  model.last_tree_times),
              "tree_times": model.last_tree_times,
              "holdout_merror": merror, "majority_error": majority})
    kernel_errs = softmax_kernels(torch, H, rates, C, cy)
    s = slice(0, CROSS_ROWS)
    gpu = HistGBT(device=DEVICE, **kw).fit(C[s], cy[s])
    cpu = HistGBT(device="cpu", **kw).fit(C[s], cy[s])
    files = [model_bytes_of(m) for m in (gpu, cpu)]
    require(files[0] == files[1], "softmax: cuda and cpu model files differ")
    emit({"phase": "softmax", "part": "cross_device", "card": smi,
          "rows": CROSS_ROWS, "identical_model_files": True,
          "identical_predictions": bool(np.array_equal(
              gpu.predict(Cv), cpu.predict(Cv)))})
    return (total, out["depthwise"], model_bytes_of(out["depthwise"]),
            kernel_errs)


def phase_resume(torch, np, H, smi, X, y, lossguide_bytes):
    """Continued training on configuration 1 (the bench's levers on the
    HIGGS-like rows): 3 trees then ``fit_device(resume=True)`` for 2 more
    write phase 5's 5-tree file; the replay of the 3-tree ensemble on the
    handle (``descend_kernel``, counted) equals the carried margins bit
    for bit; a saved 3-tree model, loaded and ``fit`` on, writes the same
    file.  Returns the launches."""
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(max_depth=MAX_DEPTH, n_bins=N_BINS)
    second = TREES - RESUME_FIRST
    with levers(BENCH_LEVERS):
        model = HistGBT(device=DEVICE, n_trees=RESUME_FIRST, **kw)
        dd = model.make_device_data(X, y)
        zero_counts(H)
        model.fit_device(dd)
        carried = model._train_preds.clone()
        model._train_preds = None
        H.descend_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replayed = model._resume_margin(dd)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        replay_launches = H.descend_kernel.launches
        require(torch.equal(replayed, carried),
                "resume: replayed margins differ from the carried ones")
        require(replay_launches == RESUME_FIRST * MAX_DEPTH,
                f"resume: the replay launched descend_kernel "
                f"{replay_launches} times, want {RESUME_FIRST * MAX_DEPTH}")
        model._train_preds = carried
        model.param.n_trees = second
        model.fit_device(dd, resume=True)
        launches = read_counts(H)
        del dd
        resumed = model_bytes_of(model, TREES)
        require(resumed == lossguide_bytes, "resume: 3 + 2 trees by "
                "fit_device(resume=True) differ from the 5-tree file")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "three.bin")
            HistGBT(device=DEVICE, n_trees=RESUME_FIRST, **kw).fit(
                X, y).save_model(path)
            loaded = HistGBT.load_model(path, device=DEVICE)
        loaded.param.n_trees = second
        t0 = time.perf_counter()
        loaded.fit(X, y)
        continue_s = time.perf_counter() - t0
        require(model_bytes_of(loaded, TREES) == lossguide_bytes,
                "resume: load_model + fit differs from the 5-tree file")
    require_launches(launches, {"hist": TREES,
                                "fused_round": (MAX_LEAVES - 1) * TREES,
                                "fused_descend": 0}, "resume")
    emit({"phase": "resume", "card": smi, "rows": len(X),
          "levers": BENCH_LEVERS, "legs": [RESUME_FIRST, second],
          "launches": launches, "replay_seconds": replay_s,
          "replay_descend_launches": replay_launches,
          "replayed_equals_carried": True,
          "resume_file_equals_uninterrupted": True,
          "load_model_fit_equals_uninterrupted": True,
          "continued_fit_seconds": continue_s})
    return launches


def phase_sampling(torch, np, H, smi, X, y, Xv, yv):
    """Row and column sampling at the flagship's shapes (depth-wise,
    ``SAMPLING``): each round's keep and feature masks on the card equal
    the CPU's at 10M rows; the draw's time per round; a sampled 3 + 2
    resume writes the uninterrupted sampled fit's file (chunks of one
    round); the cuda and cpu files of a ``CROSS_ROWS`` slice are equal.
    Returns the launches."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.utils import prng

    kw = dict(max_depth=MAX_DEPTH, n_bins=N_BINS, **SAMPLING)
    model = HistGBT(device=DEVICE, n_trees=TREES, **kw)
    with levers({}):
        dd = model.make_device_data(X, y)
        zero_counts(H)
        model.fit_device(dd)
        launches = read_counts(H)
        full = model_bytes_of(model)
        acc = float(((model.predict(Xv) > 0.5) == (yv > 0.5)).mean())
        require(acc > 0.6, f"sampling: held-out accuracy {acc} too low")
        part = HistGBT(device=DEVICE, n_trees=RESUME_FIRST, **kw)
        part.cuts = model.cuts                # the handle's cuts
        part.fit_device(dd)
        part.param.n_trees = TREES - RESUME_FIRST
        part.fit_device(dd, resume=True)
        require(model_bytes_of(part, TREES) == full,
                "sampling: a sampled 3 + 2 resume differs from the "
                "uninterrupted fit")
        del dd
    cpu = HistGBT(device="cpu", n_trees=TREES, **kw)
    base = prng.key(SAMPLING["seed"])
    kept, draw_ms = [], []
    for r in range(TREES):
        key = prng.split(prng.fold_in(base, r))[1]
        keep, feat = model._sample_masks(key, len(X), X.shape[1])
        keep_c, feat_c = cpu._sample_masks(key, len(X), X.shape[1])
        require(torch.equal(keep.cpu(), keep_c)
                and torch.equal(feat.cpu(), feat_c),
                f"sampling: round {r}'s masks differ between cuda and cpu")
        kept.append(float(keep_c.double().mean()))
        draw_ms.append(time_ms(torch, lambda: model._sample_masks(
            key, len(X), X.shape[1]), DRAW_REPS))
    s = slice(0, CROSS_ROWS)
    files = [model_bytes_of(HistGBT(device=dev, n_trees=TREES, **kw).fit(
        X[s], y[s])) for dev in (DEVICE, "cpu")]
    require(files[0] == files[1], "sampling: cuda and cpu model files differ")
    require_launches(launches, {"hist": TREES,
                                "fused_round": (MAX_DEPTH - 1) * TREES,
                                "fused_descend": 0}, "sampling")
    emit({"phase": "sampling", "card": smi, "rows": len(X), **SAMPLING,
          "trees": TREES, "launches": launches,
          "fit_seconds": model.last_fit_seconds,
          "steady_rounds_per_sec": steady_rounds_per_sec(
              model.last_tree_times),
          "kept_share_by_round": kept, "draw_ms_by_round": draw_ms,
          "draw_ms": statistics.median(draw_ms),
          "masks_equal_cpu": True, "resume_file_equals_uninterrupted": True,
          "cross_device_files_equal": True, "holdout_accuracy": acc})
    return launches


def phase_monotone(torch, np, H, smi, X, y, Xv, yv):
    """Monotone constraints at the flagship's shapes (``MONOTONE``,
    depth-wise): the margin along a ``SWEEP_POINTS``-point sweep of each
    constrained feature moves with its sign for ``SWEEP_PROBES`` held-out
    rows; the cuda and cpu files of a ``CROSS_ROWS`` slice are equal.
    Returns the launches."""
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS,
              monotone_constraints=list(MONOTONE))
    model = HistGBT(device=DEVICE, **kw)
    with levers({}):
        zero_counts(H)
        model.fit(X, y)
        launches = read_counts(H)
    require_launches(launches, {"hist": TREES,
                                "fused_round": (MAX_DEPTH - 1) * TREES,
                                "fused_descend": 0}, "monotone")
    grid = np.linspace(-4.0, 4.0, SWEEP_POINTS, dtype=np.float32)
    worst = {}
    for f, sign in enumerate(MONOTONE):
        if not sign:
            continue
        probes = np.repeat(Xv[:SWEEP_PROBES], SWEEP_POINTS, axis=0)
        probes[:, f] = np.tile(grid, SWEEP_PROBES)
        m = model.predict(probes, output_margin=True).reshape(
            SWEEP_PROBES, SWEEP_POINTS)
        step = np.diff(m, axis=1) * sign
        worst[f] = float(step.min())
        require(worst[f] >= 0.0, f"monotone: feature {f} moves against "
                f"its constraint {sign} (step {worst[f]})")
    acc = float(((model.predict(Xv) > 0.5) == (yv > 0.5)).mean())
    require(acc > 0.6, f"monotone: held-out accuracy {acc} too low")
    s = slice(0, CROSS_ROWS)
    files = [model_bytes_of(HistGBT(device=dev, **kw).fit(X[s], y[s]))
             for dev in (DEVICE, "cpu")]
    require(files[0] == files[1], "monotone: cuda and cpu model files differ")
    emit({"phase": "monotone", "card": smi, "rows": len(X),
          "constraints": {str(f): c for f, c in enumerate(MONOTONE) if c},
          "launches": launches, "fit_seconds": model.last_fit_seconds,
          "steady_rounds_per_sec": steady_rounds_per_sec(
              model.last_tree_times),
          "sweep_points": SWEEP_POINTS, "sweep_probes": SWEEP_PROBES,
          "min_step_with_sign": worst, "holdout_accuracy": acc,
          "cross_device_files_equal": True})
    return launches


def mslr_like(np, n_queries, seed, total=None):
    """MSLR-WEB10K-schema rows: ``RANK_FEATURES`` standard normal f32
    features, query lengths ~ N(120, ``RANK_LEN_SD``) rounded, at least 1
    (with ``total``: moved by one doc at a time, on random queries, until
    they sum to it), relevance 0-4 at ``RANK_LABEL_SHARES`` by the global
    quantiles of a hidden score (eight informative features under one
    rule for every seed, a query offset and noise).  Returns ``(X, y, qid, lengths)``."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(1, np.rint(rng.normal(120.0, RANK_LEN_SD, n_queries))
                      ).astype(np.int64)
    if total is not None:
        while lens.sum() != total:
            diff = int(total - lens.sum())
            pool = np.arange(n_queries) if diff > 0 else np.flatnonzero(
                lens > 1)
            pick = rng.choice(pool, min(abs(diff), len(pool)), replace=False)
            lens[pick] += 1 if diff > 0 else -1
    n = int(lens.sum())
    qid = np.repeat(np.arange(n_queries, dtype=np.int64), lens)
    X = rng.standard_normal((n, RANK_FEATURES), dtype=np.float32)
    # one hidden rule for every seed's rows
    w = np.random.default_rng(RANK_SEED).standard_normal(8).astype(np.float32)
    score = (X[:, :8] @ w + 0.5 * rng.standard_normal(n_queries)[qid]
             + rng.standard_normal(n))
    edges = np.quantile(score, np.cumsum(RANK_LABEL_SHARES)[:-1])
    y = np.digitize(score, edges).astype(np.float32)
    return X, y, qid, lens


def phase_ranking(torch, np, H, rates, smi):
    """``rank:pairwise``, ``rank:ndcg`` and ``rank:map`` with
    ``fit(qid=)`` on MSLR-WEB10K-schema rows (:func:`mslr_like`), depth 6,
    256 bins, 5 rounds each: G and the padded rows, launches set to 0
    before and read after each fit (1 ``hist`` + 5 ``fused_round`` a
    tree), the steady rounds/s, the objective's milliseconds a round,
    held-out NDCG@10 on ``RANK_HELDOUT`` further queries against a random
    order's; on a ``RANK_CROSS_QUERIES``-query slice the card's and the
    CPU's files are equal; then the two kernels against their plain
    versions on this fit's matrix (:func:`ranking_kernels`).  Returns the
    launches and the kernels' largest errors."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.models.ranking import ndcg

    t0 = time.perf_counter()
    X, y, qid, lens = mslr_like(np, RANK_QUERIES, RANK_SEED, RANK_DOCS)
    Xh, yh, qh, _ = mslr_like(np, RANK_HELDOUT, RANK_SEED + 1)
    data_s = time.perf_counter() - t0
    random_nd = ndcg(yh, np.random.default_rng(0).random(len(yh)), qh, k=10)
    cut = int(lens[:RANK_CROSS_QUERIES].sum())
    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    total = {"hist": 0, "fused_round": 0}
    out = {}
    for obj in RANK_OBJECTIVES:
        model = HistGBT(device=DEVICE, objective=obj, **kw)
        with levers({}):
            zero_counts(H)
            model.fit(X, y, qid=qid)
            launches = read_counts(H)
        require_launches(launches, {"hist": TREES,
                                    "fused_round": (MAX_DEPTH - 1) * TREES,
                                    "fused_descend": 0}, f"ranking {obj}")
        for k in total:
            total[k] += launches[k]
        G = model._obj.G
        _, yp, _ = model._regroup_ranking(X, y, qid, None)
        y_d = torch.from_numpy(yp).to(DEVICE)
        preds = model._train_preds
        obj_ms = time_ms(torch, lambda: model._obj.grad_hess(preds, y_d),
                         RANK_OBJ_REPS)
        nd = ndcg(yh, model.predict(Xh), qh, k=10)
        require(nd > random_nd, f"ranking {obj}: held-out NDCG@10 {nd} "
                f"not above a random order's {random_nd}")
        files = [model_bytes_of(HistGBT(device=dev, objective=obj, **kw).fit(
            X[:cut], y[:cut], qid=qid[:cut])) for dev in (DEVICE, "cpu")]
        require(files[0] == files[1], f"ranking {obj}: cuda and cpu model "
                f"files differ on {RANK_CROSS_QUERIES} queries")
        out[obj] = {"G": G, "padded_rows": len(yp), "launches": launches,
                    "launches_per_tree": {k: launches[k] / TREES
                                          for k in ("hist", "fused_round")},
                    "fit_seconds": model.last_fit_seconds,
                    "steady_rounds_per_sec": steady_rounds_per_sec(
                        model.last_tree_times),
                    "objective_ms": obj_ms,
                    "bin_seconds": model.last_bin_seconds,
                    "heldout_ndcg10": nd, "cross_device_files_equal": True}
        del model, preds, y_d, yp
    kernel_errs = ranking_kernels(torch, H, rates, X, y, qid)
    emit({"phase": "ranking", "card": smi, "queries": RANK_QUERIES,
          "docs": len(y), "features": RANK_FEATURES,
          "length_mean": float(lens.mean()), "length_sd": float(lens.std()),
          "length_max": int(lens.max()),
          "label_shares": np.bincount(y.astype(int), minlength=5).tolist(),
          "data_seconds": data_s, "heldout_queries": RANK_HELDOUT,
          "random_order_ndcg10": random_nd, "cross_queries":
          RANK_CROSS_QUERIES, "by_objective": out})
    return total, kernel_errs


@contextlib.contextmanager
def external_budget(budget):
    """``DMLC_TPU_EXTERNAL_DEVICE_BUDGET`` for a block (None: unset)."""
    saved = os.environ.pop(EXT_BUDGET, None)
    if budget is not None:
        os.environ[EXT_BUDGET] = str(budget)
    try:
        yield
    finally:
        os.environ.pop(EXT_BUDGET, None)
        if saved is not None:
            os.environ[EXT_BUDGET] = saved


def write_libsvm(np, path, X, y):
    """Rows as libsvm text whose f32 values read back bit for bit
    (``%.9g``)."""
    fmt = " ".join(f"{j}:%.9g" for j in range(X.shape[1]))
    with open(path, "w") as f:
        for lo in range(0, len(X), 65_536):
            f.write("".join(f"{lab:.9g} " + (fmt % tuple(row)) + "\n"
                            for lab, row in zip(y[lo:lo + 65_536].tolist(),
                                                X[lo:lo + 65_536].tolist())))


def phase_external(torch, np, H, smi, X, y, pages):
    """``fit_external`` / ``predict_iter`` on the HIGGS-like rows as
    ``ArrayRowIter`` pages of ``EXT_PAGE_ROWS``, depth 6, 256 bins, 5
    trees: (a) the default route (cached: under the 6 GiB budget); (b)
    the chunked route, the budget set for ``EXT_CHUNKS`` chunks; (c) (b)
    with ``EXT_SAMPLING``.  Checks: the card's sketch cuts equal the
    CPU's bit for bit; (a), (b) and the in-core ``fit(X, y, cuts=)`` write
    one file; (c) on an ``EXT_SLICE``-row slice (4 chunks) writes the
    CPU's file;
    ``predict_iter`` over the pages equals ``predict`` bit for bit; an
    ``EXT_SLICE``-row slice written as libsvm text and read back through
    ``RowBlockIter.create("…#cache")`` densifies to the same bits and
    trains the slice's ``ArrayRowIter`` file (with its cuts).  Launches
    (set to 0 before each route, read after): (a) 1 ``hist`` + 5
    ``fused_round`` a tree; (b), (c) ``EXT_CHUNKS`` × 6 ``hist`` and
    ``descend_kernel`` a tree.  Returns the launches."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.data.iter import ArrayRowIter, RowBlockIter
    from dmlc_core_tpu_torch.ops.quantile import SketchAccumulator

    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    n, F = X.shape
    page_rows = [b.size for b in pages]
    chunk_budget = n * 24 + F * -(-n // EXT_CHUNKS)
    routes, models = {}, {}
    for name, budget, extra in (("a", None, {}), ("b", chunk_budget, {}),
                                ("c", chunk_budget, EXT_SAMPLING)):
        model = HistGBT(device=DEVICE, **kw, **extra)
        with levers({}), external_budget(budget):
            zero_counts(H)
            model.fit_external(pages)
            launches = read_counts(H)
            descends = H.descend_kernel.launches
        want_route = "cached" if name == "a" else "chunked"
        require(model.last_external_route == want_route,
                f"external ({name}): took the {model.last_external_route} "
                f"route, want {want_route}")
        if name == "a":
            require_launches(launches, {
                "hist": TREES, "fused_round": (MAX_DEPTH - 1) * TREES,
                "fused_descend": 0}, "external (a)")
        else:
            require(model.last_external_chunks == EXT_CHUNKS,
                    f"external ({name}): {model.last_external_chunks} chunks")
            require_launches(launches, {
                "hist": EXT_CHUNKS * MAX_DEPTH * TREES, "fused_round": 0,
                "fused_descend": 0}, f"external ({name})")
            require(descends == EXT_CHUNKS * MAX_DEPTH * TREES,
                    f"external ({name}): descend_kernel launched {descends}"
                    f" times, want {EXT_CHUNKS * MAX_DEPTH * TREES}")
            want_up = (MAX_DEPTH + 1) * n * F * TREES
            require(model.last_upload_bytes == want_up,
                    f"external ({name}): uploaded {model.last_upload_bytes}"
                    f" bin bytes, want {want_up}")
        models[name] = model
        routes[name] = {
            "route": model.last_external_route, "env": extra,
            "budget": budget, "chunks": model.last_external_chunks,
            "launches": launches, "descend_launches": descends,
            "launches_per_tree": {"hist": launches["hist"] / TREES,
                                  "fused_round": launches["fused_round"]
                                  / TREES, "descend": descends / TREES},
            "sketch_seconds": model.last_sketch_seconds,
            "bin_seconds": model.last_bin_seconds,
            "fit_seconds": model.last_fit_seconds,
            "steady_rounds_per_sec": steady_rounds_per_sec(
                model.last_tree_times),
            "upload_bytes_per_tree": (None if name == "a" else
                                      model.last_upload_bytes / TREES)}
    # the sketch on the CPU, over the same pages
    t0 = time.perf_counter()
    sk = SketchAccumulator(F, n_summary=max(8 * N_BINS, 64), device="cpu")
    for b in pages:
        sk.add(b.to_dense(F))
    cpu_cuts = sk.finalize(N_BINS)
    cpu_sketch_s = time.perf_counter() - t0
    require(cpu_cuts.numpy().tobytes() ==
            models["a"].cuts.cpu().numpy().tobytes(),
            "external: the card's sketch cuts differ from the CPU's")
    with levers({}):
        incore = HistGBT(device=DEVICE, **kw).fit(
            X, y, cuts=models["a"].cuts.cpu().numpy())
    ref = model_bytes_of(incore)
    require(model_bytes_of(models["a"]) == ref, "external: the cached "
            "route's file differs from the in-core fit's")
    require(model_bytes_of(models["b"]) == ref, "external: the chunked "
            "route's file differs from the in-core fit's")
    # (c) on a slice, on the card and on the CPU: the same draws, upload
    # per level and feature masks in the split scoring give one file
    s = slice(0, EXT_SLICE)
    slice_budget = EXT_SLICE * 24 + F * -(-EXT_SLICE // EXT_CHUNKS)
    sampled = []
    for dev in (DEVICE, "cpu"):
        m = HistGBT(device=dev, **kw, **EXT_SAMPLING)
        with levers({}), external_budget(slice_budget):
            m.fit_external(ArrayRowIter(X[s], y[s], page_rows=EXT_PAGE_ROWS))
        require(m.last_external_route == "chunked"
                and m.last_external_chunks == EXT_CHUNKS,
                f"external (c) slice on {dev}: {m.last_external_route} "
                f"route, {m.last_external_chunks} chunks")
        sampled.append(model_bytes_of(m))
    require(sampled[0] == sampled[1], "external (c): the card's sampled "
            f"chunked file differs from the CPU's on {EXT_SLICE} rows")
    kept = [float(models["c"]._ext_sample_masks(r, page_rows, F)[0].mean())
            for r in range(TREES)]
    t0 = time.perf_counter()
    got = models["a"].predict_iter(pages)
    iter_s = time.perf_counter() - t0
    require(got.tobytes() == models["a"].predict(X).tobytes(),
            "external: predict_iter differs from predict")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slice.libsvm")
        t0 = time.perf_counter()
        write_libsvm(np, path, X[s], y[s])
        write_s = time.perf_counter() - t0
        arr = HistGBT(device=DEVICE, **kw).fit_external(ArrayRowIter(
            X[s], y[s], page_rows=EXT_PAGE_ROWS))
        t0 = time.perf_counter()
        it = RowBlockIter.create(f"{path}#{os.path.join(d, 'cache')}", 0, 1,
                                 "libsvm")
        dense = np.concatenate([b.to_dense(F) for b in it])
        parse_s = time.perf_counter() - t0
        require(dense.tobytes() == np.ascontiguousarray(X[s]).tobytes(),
                "external: the libsvm slice does not read back bit for bit")
        disk = HistGBT(device=DEVICE, **kw).fit_external(
            it, num_col=F, cuts=arr.cuts.cpu().numpy())
        it.close()
    require(model_bytes_of(disk) == model_bytes_of(arr), "external: the "
            "DiskRowIter slice's file differs from the ArrayRowIter's")
    emit({"phase": "external", "card": smi, "rows": n, "features": F,
          "pages": len(page_rows), "page_rows": EXT_PAGE_ROWS,
          "routes": routes,
          "cpu_sketch_seconds": cpu_sketch_s, "cuts_equal_cpu": True,
          "files_equal_incore": ["a", "b"],
          "sampled_kept_share_by_round": kept,
          "sampled_slice_file_equals_cpu": True,
          "predict_iter_seconds": iter_s, "predict_iter_equals_predict": True,
          "slice_rows": EXT_SLICE, "libsvm_write_seconds": write_s,
          "libsvm_parse_seconds": parse_s, "disk_file_equals_array": True})
    total = {"hist": 0, "fused_round": 0}
    for r in routes.values():
        for k in total:
            total[k] += r["launches"][k]
    return total


def phase_ingest_iter(torch, np, H, smi, pages, X, y):
    """``HistGBT.make_device_data_iter`` over the external phase's pages
    (each page densified as ``fit_external`` does, ``EXT_PAGE_ROWS``-row
    slabs): pass 1 the
    sketch on the card, pass 2 the slabs through ``DeviceFeed`` binned on
    the card.  Checks: its bins, labels and weights ``torch.equal`` to
    ``make_device_data(X, y, cuts=same)``'s on the card, and a
    ``TREES``-tree ``fit_device`` from each handle writes one file (1
    ``hist`` + 5 ``fused_round`` a tree, counts set to 0 before each fit
    and read after).  Prints both passes' seconds, each handle's peak of
    ``torch.cuda.max_memory_allocated`` over what was resident before it,
    and the feed's stall fraction.  Returns the streamed handle's fit's
    launches."""
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    n, F = X.shape

    def slabs():
        return ((b.to_dense(F), b.label, b.weight) for b in pages)

    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() - base

    with levers({}):
        streamed = HistGBT(device=DEVICE, **kw)
        dd, iter_s, iter_peak = peak_of(
            lambda: streamed.make_device_data_iter(slabs))
        incore = HistGBT(device=DEVICE, **kw)
        ref, ref_s, ref_peak = peak_of(
            lambda: incore.make_device_data(X, y, cuts=streamed.cuts))
        for key in ("bins_t", "y_d", "w_d"):
            require(torch.equal(dd[key], ref[key]), f"ingest_iter: the "
                    f"streamed handle's {key} differs from make_device_data's")
        require(sorted(dd) == sorted(ref), "ingest_iter: handle keys differ")
        fits = {}
        for name, model, handle in (("iter", streamed, dd),
                                    ("in_core", incore, ref)):
            zero_counts(H)
            model.fit_device(handle)
            fits[name] = read_counts(H)
            require_launches(fits[name], {
                "hist": TREES, "fused_round": (MAX_DEPTH - 1) * TREES,
                "fused_descend": 0}, f"ingest_iter ({name})")
    require(model_bytes_of(streamed) == model_bytes_of(incore),
            "ingest_iter: the streamed handle's file differs from "
            "make_device_data's")
    feed = streamed.last_feed_stats
    emit({"phase": "ingest_iter", "card": smi, "rows": n, "features": F,
          "slabs": feed["batches"], "slab_rows": EXT_PAGE_ROWS,
          "pass1_sketch_seconds": streamed.last_sketch_seconds,
          "pass2_feed_bin_seconds": (streamed.last_bin_seconds
                                     - streamed.last_sketch_seconds),
          "iter_seconds": iter_s, "make_device_data_seconds": ref_s,
          "iter_peak_bytes": iter_peak, "make_device_data_peak_bytes":
          ref_peak, "bin_matrix_bytes": n * F,
          "feed_stall_fraction": feed["stall_fraction"], "feed": feed,
          "bins_equal": True, "file_equal": True,
          "launches": fits["iter"],
          "steady_rounds_per_sec": steady_rounds_per_sec(
              streamed.last_tree_times)})
    return fits["iter"]


def phase_infeed(torch, smi):
    """The port bench's infeed smoke (``bench._smoke_infeed``): 24
    ``[2048, 128]`` f32 batches through ``DeviceFeed(depth=2)`` onto the
    card, each consumed by ``sum(tanh(x @ w))``."""
    from dmlc_core_tpu_torch import bench

    t0 = time.perf_counter()
    frac = bench._smoke_infeed(torch.device(DEVICE))
    wall = time.perf_counter() - t0
    require(0.0 <= frac <= 1.0, f"infeed: stall fraction {frac}")
    emit({"phase": "infeed", "card": smi, "infeed_stall_frac": frac,
          "batches": 24, "batch_shape": [2048, 128], "seconds": wall})


def sparse_round_device_ms(torch, data, F, kw):
    """A ``SparseHistGBT`` round's device time by group (the kernels
    launched in the ``torch.profiler`` ranges ``sparse.histogram`` /
    ``.route`` / ``.split``, and each range's span on the device), the
    mean over a ``SPARSE_PROFILE_TREES``-tree fit under the profiler, with
    the wall of the fit, its set-up, the device time of every kernel in it
    (set-up included) and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from dmlc_core_tpu_torch.models.histgbt_sparse import (PROFILE_GROUPS,
                                                           SparseHistGBT)

    offset, index, value, y = data
    T = SPARSE_PROFILE_TREES
    model = SparseHistGBT(device=DEVICE, **{**kw, "n_trees": T})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.fit(offset, index, value, y, n_features=F)
        torch.cuda.synchronize()
    # a range's host-side event sums the device time of the kernels it
    # launched; its device-side twin (the same name) spans them, gaps
    # included
    groups = {g: 0.0 for g in PROFILE_GROUPS}
    spans = {g: 0.0 for g in PROFILE_GROUPS}
    kernels_us = 0.0
    top = {}
    cuda = torch.autograd.DeviceType.CUDA
    for evt in prof.key_averages():
        if evt.key in groups:
            (spans if evt.device_type == cuda else groups)[evt.key] += \
                evt.device_time_total / 1e3 / T
        elif evt.device_type == cuda:
            us = getattr(evt, "self_device_time_total", 0.0)
            kernels_us += us
            if not evt.key.startswith("Memcpy"):
                top[evt.key[:90]] = (us / 1e3, evt.count)
    return {"trees": T, "by_group_ms": groups,
            "round_ms": sum(groups.values()), "by_group_span_ms": spans,
            "fit_kernels_ms": kernels_us / 1e3,
            "top_kernels_ms_launches": dict(sorted(
                top.items(), key=lambda kv: -kv[1][0])[:20]),
            "fit_wall_ms": model.last_fit_seconds * 1e3,
            "setup_ms": model.last_setup_seconds * 1e3}


def phase_sparse(torch, np, smi):
    """``SparseHistGBT`` at ``tools/bench_sparse.py``'s defaults on the
    card (its warm-up fits, timed fit and predict): rounds/s, predict
    rows/s, train accuracy above ``SPARSE_MIN_ACC``; one round's device
    time by group from ``torch.profiler``; on the first ``SPARSE_SLICE``
    rows (``SPARSE_SLICE_TREES`` trees, the full F) the card's model file
    equal to the CPU's, and ``SPARSE_RANKS`` gloo ranks sharing the card,
    each with its half of the slice's rows and the 1-process cuts, each
    writing the card's 1-process file."""
    from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT
    from dmlc_core_tpu_torch.parallel.launch import launch
    from dmlc_core_tpu_torch.tools import bench_sparse as BS

    k = BS.knobs()
    t0 = time.perf_counter()
    data = BS.sparse_data(k["n"], k["F"], k["density"])
    gen_s = time.perf_counter() - t0
    rec = BS.run(DEVICE, data=data)
    rec.pop("_model")
    require(rec["train_acc"] > SPARSE_MIN_ACC,
            f"sparse: train accuracy {rec['train_acc']}")
    kw = dict(max_depth=k["depth"], n_bins=k["n_bins"], learning_rate=0.3)
    prof = sparse_round_device_ms(torch, data, k["F"], kw)
    offset, index, value, y = data
    s = SPARSE_SLICE
    sl = (offset[:s + 1], index[:offset[s]], value[:offset[s]], y[:s])
    files, cross_s = [], {}
    one = None
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        m = SparseHistGBT(device=dev, n_trees=SPARSE_SLICE_TREES, **kw).fit(
            *sl, n_features=k["F"])
        cross_s[dev] = time.perf_counter() - t0
        files.append(model_bytes_of(m))
        one = one or m
    require(files[0] == files[1], f"sparse: the card's file differs from "
            f"the CPU's on {s} rows")
    with tempfile.TemporaryDirectory() as d:
        csr = os.path.join(d, "csr.npz")
        np.savez(csr, offset=sl[0], index=sl[1], value=sl[2], y=sl[3])
        cuts = os.path.join(d, "cuts.npz")
        np.savez(cuts, cut_vals=one.cuts.cut_vals, cut_ptr=one.cuts.cut_ptr)
        t0 = time.perf_counter()
        launch({"backend": "gloo", "device": f"{DEVICE}:0",
                "params": dict(n_trees=SPARSE_SLICE_TREES, **kw),
                "runs": [{"name": "sparse", "sparse": {
                    "csr": csr, "n_features": k["F"], "cuts": cuts}}],
                "out": d}, world=SPARSE_RANKS, timeout=DP_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        for r in range(SPARSE_RANKS):
            with open(os.path.join(d, f"sparse.{r}.model"), "rb") as f:
                require(f.read() == files[0], f"sparse: rank {r} of "
                        f"{SPARSE_RANKS} wrote another file than 1 process")
    emit({"phase": "sparse", "card": smi,
          **{key: rec[key] for key in (
              "value", "unit", "rows", "features", "nnz", "density",
              "total_bins", "dense_bins_would_be", "n_bins", "depth",
              "rounds", "warmup_seconds", "fit_seconds", "setup_seconds",
              "predict_seconds", "predict_rows_per_sec", "train_acc")},
          "rounds_per_sec": rec["value"], "gen_seconds": gen_s,
          "round_device_ms": prof, "slice_rows": s,
          "slice_trees": SPARSE_SLICE_TREES, "slice_seconds": cross_s,
          "slice_file_equals_cpu": True, "ranks": SPARSE_RANKS,
          "ranks_seconds": ranks_s, "ranks_file_equals_one_process": True})


def phase_introspect(np, H, smi, models):
    """``predict_leaf`` on the card equals the CPU's (the model loaded on
    the CPU from its file), and ``dump_model`` (with stats) and
    ``feature_importances`` (both types) give equal strings, for each of
    ``models`` (name → (model, held-out rows)).  Returns the launches of
    the card's ``predict_leaf``."""
    from dmlc_core_tpu_torch import HistGBT

    total = 0
    for name, (model, rows) in models.items():
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "model.bin")
            model.save_model(path)
            cpu = HistGBT.load_model(path, device="cpu")
        H.descend_kernel.launches = 0
        leaves = model.predict_leaf(rows)
        total += H.descend_kernel.launches
        want = cpu.predict_leaf(rows)
        require(leaves.dtype == np.int32 and np.array_equal(leaves, want),
                f"introspect {name}: predict_leaf differs between cuda and "
                "cpu")
        dump = model.dump_model(with_stats=True)
        require(dump == cpu.dump_model(with_stats=True),
                f"introspect {name}: dump_model differs")
        imp = {t: model.feature_importances(t).tolist()
               for t in ("weight", "gain")}
        require(all(repr(imp[t]) == repr(cpu.feature_importances(t).tolist())
                    for t in imp),
                f"introspect {name}: feature_importances differ")
        emit({"phase": "introspect", "model": name, "card": smi,
              "rows": len(rows), "leaf_shape": list(leaves.shape),
              "descend_launches": H.descend_kernel.launches,
              "dump_lines": dump.count("\n"),
              "dump_sha_prefix": hashlib.sha256(
                  dump.encode()).hexdigest()[:16],
              "importance_weight": imp["weight"]})
    return total


def phase_data_parallel(torch, np, H, rates, X, y, Xv, yv, main, lossguide,
                        missing, softmax):
    """The data-parallel path on this card.  ``main`` / ``lossguide``:
    ``(stats, model bytes)`` of phases 4 and 5; ``missing``: ``(X, y,
    model bytes)`` of the cross-device phase's missing slice, which two
    gloo ranks fit too; ``softmax``: ``(X, y, model bytes)`` of the
    softmax phase's depth-wise fit, likewise.  Returns the launches of
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
        np.save(os.path.join(d, "Xm.npy"), missing[0])
        np.save(os.path.join(d, "ym.npy"), missing[1])
        np.save(os.path.join(d, "Xs.npy"), softmax[0])
        np.save(os.path.join(d, "ys.npy"), softmax[1])
        t0 = time.perf_counter()
        launch({"X": os.path.join(d, "X.npy"),
                "y": os.path.join(d, "y.npy"),
                "Xv": os.path.join(d, "Xv.npy"), "backend": "gloo",
                "device": "cuda:0", "threads": 1,
                "params": {"n_trees": TREES, "max_depth": MAX_DEPTH,
                           "n_bins": N_BINS},
                "runs": [{"name": k, "env": env}
                         for k, (env, _) in runs.items()] + [
                    {"name": "missing", "env": {},
                     "X": os.path.join(d, "Xm.npy"),
                     "y": os.path.join(d, "ym.npy"), "Xv": None},
                    {"name": "softmax", "env": FUSED_DESCEND,
                     "X": os.path.join(d, "Xs.npy"),
                     "y": os.path.join(d, "ys.npy"), "Xv": None,
                     "params": SOFTMAX}],
                "out": os.path.join(d, "out")}, DP_RANKS, DP_TIMEOUT)
        group_s = time.perf_counter() - t0
        out = os.path.join(d, "out")
        # NaN-as-missing on the two ranks: the 1-process card's file
        for r in range(DP_RANKS):
            with open(os.path.join(out, f"missing.{r}.json")) as f:
                st = json.load(f)
            with open(os.path.join(out, f"missing.{r}.model"), "rb") as f:
                require(f.read() == missing[2], f"data_parallel missing: "
                        f"rank {r}'s model file differs from the "
                        "1-process fit's")
            require(st["missing"], "data_parallel missing: not in "
                    "missing mode")
            require_launches(st["launches"], {
                "hist": MAX_DEPTH * TREES, "fused_round": 0,
                "hist_layout": 0, "fused_round_layout": 0,
                "fused_descend": 0, "descend_dir": MAX_DEPTH * TREES},
                f"data_parallel missing rank {r}")
            for k, v in st["launches"].items():
                total[k] += v
        emit({"phase": "data_parallel", "part": "missing",
              "backend": "gloo", "world": DP_RANKS,
              "rows": len(missing[0]), "launches_per_rank": st["launches"],
              "same_model_file_as_one_process": True,
              "device_allreduces": st["device_allreduces"]})
        # multi:softmax on the two ranks: K class trees a round, each
        # level's left children synced
        K = SOFTMAX["num_class"]
        for r in range(DP_RANKS):
            with open(os.path.join(out, f"softmax.{r}.json")) as f:
                st = json.load(f)
            with open(os.path.join(out, f"softmax.{r}.model"), "rb") as f:
                require(f.read() == softmax[2], f"data_parallel softmax: "
                        f"rank {r}'s model file differs from the "
                        "1-process fit's")
            require_launches(st["launches"], {
                "hist": K * TREES, "fused_round": 0, "hist_layout": 0,
                "fused_round_layout": 0,
                "fused_descend": K * (MAX_DEPTH - 1) * TREES,
                "descend_dir": 0}, f"data_parallel softmax rank {r}")
            for k, v in st["launches"].items():
                total[k] += v
        emit({"phase": "data_parallel", "part": "softmax",
              "backend": "gloo", "world": DP_RANKS,
              "rows": len(softmax[0]), "classes": K,
              "launches_per_rank": st["launches"],
              "same_model_file_as_one_process": True,
              "fit_seconds": st["fit_seconds"],
              "device_allreduces": st["device_allreduces"],
              "hist_sync_bytes": st["hist_sync_bytes"]})
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
    infeed = rec.get("infeed_stall_frac") or {}
    require(0.0 <= infeed.get("value", -1.0) <= 1.0,
            f"bench: infeed_stall_frac {rec.get('infeed_stall_frac')}")
    phases = {}
    for ln in lines:
        r = json.loads(ln)
        phases.setdefault(r["phase"], r["elapsed_s"])
    keys = ("value", "value_basis", "rounds_per_sec_median_chunk",
            "rounds_per_sec_best_chunk", "chunk_seconds_per_round",
            "seconds", "warmup_seconds", "warm_dispatch_seconds",
            "infeed_stall_frac",
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
    from dmlc_core_tpu_torch.data.iter import ArrayRowIter
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
    # the same rows' cover types (7 classes)
    c7 = covtype_like(np, COVTYPE_ROWS, COVTYPE_SEED, classes=7)[1]
    c7v = covtype_like(np, 100_000, COVTYPE_SEED + 1, classes=7)[1]
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "higgs_like": list(X.shape), "covtype_like": list(C.shape),
          "covtype_positive_share": float(cy.mean())})
    check_inf_binning(torch, np)
    kernels = phase_kernels(torch, H, rates)
    layout_kernels, mats = phase_kernels_layout(torch, np, H, rates, C, cy)
    kernels.update(layout_kernels)
    Xm, Xmv, kernels["descend_dir"], miss_stats = phase_missing(
        torch, np, H, rates, X, y, Xv, yv)
    launches = {k: 0 for k in kernels}
    main_fit = phase_main(torch, np, H, rates, X, y, Xv, yv)
    lossguide_fit = phase_main_lossguide(torch, np, H, rates, X, y, Xv, yv)
    for counts in (miss_stats["launches"], main_fit[0]["launches"],
                   lossguide_fit[0]["launches"],
                   phase_levers(torch, np, H, rates, C, cy, Cv, cyv),
                   phase_eval_set(torch, np, H, Xm, y, Xmv, yv)):
        for k, v in counts.items():
            launches[k] += v
    softmax_launches, softmax_model, softmax_bytes, softmax_errs = \
        phase_softmax(torch, np, H, rates, smi, C, c7, Cv, c7v)
    for k, err in softmax_errs.items():
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], err)
    ranking_launches, ranking_errs = phase_ranking(torch, np, H, rates, smi)
    for k, err in ranking_errs.items():
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], err)
    t0 = time.perf_counter()
    pages = ArrayRowIter(X, y, page_rows=EXT_PAGE_ROWS)
    emit({"phase": "pages", "pages": sum(1 for _ in pages),
          "seconds": time.perf_counter() - t0})
    for counts in (softmax_launches,
                   phase_resume(torch, np, H, smi, X, y, lossguide_fit[1]),
                   phase_sampling(torch, np, H, smi, X, y, Xv, yv),
                   phase_monotone(torch, np, H, smi, X, y, Xv, yv),
                   phase_external(torch, np, H, smi, X, y, pages),
                   phase_ingest_iter(torch, np, H, smi, pages, X, y),
                   ranking_launches):
        for k, v in counts.items():
            launches[k] += v
    del pages
    phase_infeed(torch, smi)
    phase_introspect(np, H, smi, {"main": (main_fit[2], Xv),
                                  "softmax": (softmax_model, Cv)})
    s = slice(0, CROSS_ROWS)
    files = phase_cross_device(np, {
        "depthwise": (X[s], y[s], {}),
        "1": (X[s], y[s], BENCH_LEVERS),
        "2a": (C[s], cy[s], BENCH_LEVERS),
        "2b": (C[s], cy[s], PACK_ONLY),
        "missing": (Xm[s], y[s], {})})
    for k, v in phase_data_parallel(
            torch, np, H, rates, X, y, Xv, yv, main_fit, lossguide_fit,
            (Xm[s], y[s], files["missing"]),
            (C, c7, softmax_bytes)).items():
        launches[k] += v
    del C, cy, c7, softmax_model
    del Xm, Xmv
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
    phase_sparse(torch, np, smi)
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
                # B2's descend, in the direction mode of the unfused
                # chain's descend (fused_descend_histogram's dir_sel)
                "descend_dir": "dmlc_core_tpu/ops/histogram.py:531",
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
