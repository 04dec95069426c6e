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
    makes them), causal at the same shape, at a rank's head shard under
    Ulysses at seq 2 (``[8, 512, 6, 64]``), and at sequences that are no
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
11b. bert_parallel — BERT's parallel axes at BERT-base width: (a) one
    rank on ``create_mesh(MeshSpec(data=1))`` (every axis named at size
    1; its ``seq`` axis takes ring attention, as JAX's does), its first
    loss within 2e-3 of phase 11's; (b) two gloo ranks sharing the card
    (``tools/bert_mesh.py`` as child processes with a time limit), 3
    steps each on ``model=2``, ``seq=2`` ring, ``seq=2`` Ulysses,
    ``data=2`` with the KVStore sync, and ``expert=2`` Switch-MoE (8
    experts), each held to one rank's run from the same weights (losses
    within 2e-3, gathered weights within 1e-3); the flash kernels'
    launches counted on the Ulysses run (12 of each a step); steps/s and
    the host-staged bytes a step printed (ranks sharing one card: no
    scaling);
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
12c. linear — ``GBLinear`` at Criteo's width: 50M × 39 rows by
    ``cpp/gen_libsvm.cc``'s rule (seed 7, made on the card:
    :func:`criteo_like`), 50 rounds, bf16 then f32: rounds/s from the
    chunk evidence and the fit's peak device memory, held below X's bytes
    plus the labels and weights, three upload slabs (``DeviceFeed``'s)
    and a row block's temporaries; ``fit_iter`` over 50k rows of libsvm
    text equal to ``fit``; the card's weights within rtol 2e-4, atol 2e-6
    of the CPU's on 100k rows; ``save_model`` → ``load_model``;
12d. fm — ``FM`` (k = 8, batch 8192) on the first 10M of those rows, one
    epoch: steps/s, the held-out logloss falling; the card within rtol
    1e-3, atol 1e-4 of the CPU on 100k rows; a saved and loaded model
    resuming the same epoch bit for bit (parameters and Adam state);
12e. sklearn — ``GBTClassifier`` with ``booster="gbtree"`` and
    ``"gblinear"`` on 1M of those rows and the sparse route on a scipy
    CSR of 100k: held-out accuracy, probabilities, the card's booster
    file equal to the CPU's on 20k rows (gblinear: within its
    tolerance);
12f. serve — phase 5's model (configuration 1) in a ``ModelRegistry``,
    its ladder 8..256 warmed: at every bucket (full and partly padded)
    the served predictions bit-identical to ``predict`` and to the CPU's
    ``predict`` of the same file, 30 ``descend_kernel`` launches (trees ×
    depth) a batch; ``descend_kernel`` against ``descend_plain`` at a
    256-row batch's shapes, every tree and level, timed beside its bound;
    the HTTP frontend end to end (4 clients, a hot swap to phase 4's
    model under traffic, every response bit-identical to the version it
    reports, trees × depth launches a batch, the counts set to 0 just
    before and read just after); GBLinear, FM and SparseHistGBT through
    ``ModelRunner``, bit-identical to their ``predict``; the port
    bench's ``--serve`` as a child process at its defaults;
12g. tenancy — 12 ``HistGBT`` tenants (3..6 trees, depth 3..6, each its
    own label) fit on the card, published to a
    ``TenantRegistry(device="cuda")`` with a resident cap of 4 and served
    through the frontend's ``tenants=`` seam over HTTP: Zipf(1.1) traffic
    from one client with the ``X-Dmlc-Tenant`` header, every response
    bit-identical to that tenant's ``predict`` on the card and to the
    CPU's ``predict`` of the same bytes; evictions and restores both > 0,
    each tenant's probe answered alike before and after the traffic;
    ``descend_kernel`` launched trees × depth a batch, plus trees × depth
    × the ladder's 4 buckets for each page-in's warmup (the counts set to
    0 just before and read just after); ``torch.cuda.memory_allocated``
    with the cap full and after the run, the page-ins' wall times; then
    the port bench's ``--tenants`` as a child process at its defaults;
12h. fleet — (a) in process, on the card: a ``FleetTracker``, 3
    ``Replica(device="cuda")`` holding the port bench's v1 (5 trees,
    depth 4) and a ``FleetRouter``: sequential routed predicts
    bit-identical to the direct ``predict`` of the version each response
    reports (and to the CPU's), trees × depth launches a batch, the
    routed latency; one replica killed uncleanly under 3 clients' traffic
    (zero dropped, zero wrong); a staged rollout to v2 (10 trees) under
    traffic converging on v2; no replica answered a predict with 500
    (the router would fail it over); (b) the port bench's ``--fleet`` as
    a child process at its defaults, its 3 replicas subprocesses on the
    card: no drop, no wrong answer, no respawn, no transport failover,
    the rollout activated, every replica on v2 after it and 20 routed
    answers v2's;
12i. stream — ``OnlineTrainer`` on the card at the stream bench's
    defaults (chunks of 1024 HIGGS-like events of 28 features from a
    RecordIO shard written from a seed, a window of 2, 5 trees a refresh
    at depth 4 and 32 bins) behind a ``ModelPublisher`` with a 4096-row
    holdout: 6 refreshes with the launch counts set to 0 just before and
    read just after (``hist`` once and ``fused_round`` three times a
    tree, ``descend_kernel`` for the margin replay and the gate); the
    card's model file after 3 refreshes equal to the CPU's; the
    warm-start contract on the card (window 1, decay 1 over chunks A
    then B writes ``fit(A); fit(B)``'s file); two refreshes on
    flipped labels rolled back by the gate, traffic on the good
    version; then one refresh at ``chunk_rows`` 262,144 (window 2:
    524,288 × 28) with its tail, decode, fit and publish seconds, and
    ``hist``, ``fused_round`` and ``descend_kernel`` held against their
    plain versions at that window's shapes; then the port bench's
    ``--stream`` as a child process at its defaults (staleness
    percentiles, at least one refresh published);
12j. ps — an in-process scheduler and 2 servers, 2 worker threads each
    running ``GBLinear.fit_ps`` and then ``FM.fit_ps`` with the models
    on the card (10,000 sparse CTR rows each, 20,000 hashed features): the
    finalized ``predict`` on the card against the CPU's on the same
    weights (rtol 1e-5, atol 1e-5), the SSP lag within its bound;
    ``KVStore("local")`` on the card writing the CPU's bytes; then the
    port bench's ``--ps`` as a child process at its defaults
    (``staleness_max`` within ``staleness_bound``, ``keys_per_sec``);
12k. recovery — ``ElasticTrainer.run_device`` on configuration 1's
    handle (phase 5's model), stride 2, killed after the round-2 commit
    by the ``worker`` fault point and resumed by a fresh model: phase
    5's file byte for byte; then ``ElasticTrainer.run`` with 2 worker
    threads on the card under an ``ElasticTracker`` (200,000 rows, each
    worker's ``ElasticSession`` its thread's host transport), clean,
    then with worker 1 killed after its first commit and a replacement
    rejoining its rank: the same file as the clean run;
12k2. submit — ``dmlc-submit``'s local cluster on the card, workers
    that read from an object store: the first 1M of configuration 1's
    HIGGS-like rows (seed 7) as ``%.9g`` libsvm text in 4 shards
    (~0.4 GB) on local disk and behind an S3 fake in this process
    (:func:`s3_fake`, reached through ``S3_ENDPOINT``); configuration 1's
    widths grown depth-wise (the external engine's chunked route is
    depth-wise, as the JAX package's), one set of cuts.  (iii) the
    in-core fit on the card on the rows the native parser reads back
    (the count of values differing from the generator's f32 rows
    printed); (i) ``python -m dmlc_core_tpu_torch.tracker.submit
    --cluster local --num-workers 2`` from ``s3://``, gloo ranks sharing
    the card, each parsing its ``InputSplit`` part natively and fitting
    by ``fit_external``; (ii) ``--num-workers 1`` from the local shards,
    a NCCL group of one, through the native chunk reader, started
    beside (i): (i)'s and
    (ii)'s files byte-identical to (iii)'s, every rank's native parse
    calls (and (ii)'s native chunk reads) above 0;
12l. resnet — (a) trainer steps on the card against the same steps on
    the CPU from the same carried weights: ``resnet-micro`` (basic
    blocks) and a bottleneck micro model (1×1 projections, strided 3×3
    convs), each 3 steps at 16 × 32² in f32 with cuDNN's TF32 off
    (scoped by ``torch.backends.cudnn.flags``; losses and BN statistics
    within 1e-4 of the CPU's, the update within 1e-3) and in bf16 (2e-3,
    3e-3, 0.1), and ResNet-50 at its real widths, 2 f32 steps at 8 × 64²
    (1e-4, 1e-3, and 0.1 for the update: ReLU inputs within rounding of
    0, ROADMAP C18); (b) ``tools/bench_resnet_feed.py``'s legs at full width
    (ResNet-50, 224², batch 256, bf16, 1536 synthetic records in 4
    RecordIO shards): finite losses, the end-to-end epoch's 6 steps with
    a stall fraction in [0, 1], the step's time beside its bound (6.22
    TFLOP counted from the model's layers: 6.29 ms), the peak device
    memory; the records decoded by the native RecordIO codec (its call
    count above 0), and the host leg's records/s with the native and with
    the Python decode in turns (:func:`codec_ab`);
12m. prodsim — ``python -m dmlc_core_tpu_torch.tools.check_prodsim`` as
    a child process on the card (the production-day drill under the
    lock-order, race and leak checkers, a fault in every tier, the
    scorecard ``tools/slo/prodsim.json``): every check green; its
    availability, tiers faulted, scorecard and the kernels' launches of
    the drill process and of the replicas alive at its end;
13. bench — ``python -m dmlc_core_tpu_torch.bench`` as a child process at
    its defaults (10M × 28, 100 rounds after 10 warmup rounds, the
    flagship's levers, host binning), with a time limit: its last line
    must be the final ``histgbt_rounds_per_sec_per_chip`` record of 100
    rounds, with kernel launches, a ``kvstore_sync_ms`` and the scaling
    probe's ``scaling_efficiency`` (8 gloo ranks of the host at
    ``BENCH_PROBE_ROWS``; or the budget note that skipped it), and its
    headline fields are emitted;
14. the ``kernels`` line (launches summed over phases 3b-6h and 8, phases
    11 and 11b's Ulysses run for attention — each beside its part and the
    kernels' times at the Ulysses shard —, phase 12's timing pass for the
    B5 variants, phases
    12f-12h's HTTP runs for ``descend``, phase 12i's refreshes for
    ``hist``, ``fused_round`` and ``descend``, phase 12k2's three runs
    for the same three (``launches_submit``) and phase 12m's drill for
    the same three; ``descend_dir`` is
    ``descend_kernel``'s direction mode, B2's descend on the missing
    path, ``descend`` its plain mode, a served batch's and a refresh's
    margin replay), then the card's name and power limit, then the
    ``ok`` line.

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
import shutil
import signal
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
               ("d128_causal", (2, 130, 2, 128), True),
               # a rank's head shard under Ulysses at seq = 2 (BERT-base)
               ("ulysses", (8, 512, 6, 64), False))
#: shapes timed as well as checked
ATTN_TIMED = ("bert", "bert_causal", "ulysses")
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
#: BERT's parallel axes at BERT-base width: two gloo ranks sharing this
#: card (NCCL refuses two ranks on one GPU), each mesh for a few steps
#: from the weights of seed 0, held to one rank's run from those weights.
#: The MoE run's capacity is loose (2× the mean load): capacity binds per
#: dispatch group by design, so a tight one would drop other tokens on
#: two ranks than on one (the JAX package's parity test loosens it alike)
BERT_PAR_RANKS = 2
BERT_PAR_STEPS = 3
BERT_PAR_TIMEOUT = 600
BERT_PAR_RUNS = (
    ("model2", {"data": 1, "model": 2}, {}),
    ("seq2_ring", {"data": 1, "seq": 2}, {}),
    ("seq2_ulysses", {"data": 1, "seq": 2}, {"sp_method": "ulysses"}),
    ("data2_kvstore", {"data": 2}, {"grad_sync": "kvstore"}),
    ("expert2_moe", {"data": 1, "expert": 2},
     {"ffn_type": "moe", "n_experts": 8, "capacity_factor": 2.0}))
#: BERT keywords of the phase (none: BERT-base)
BERT_PAR_KW: dict = {}
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
#: linear: GBLinear at Criteo's width, scripts/bench_gblinear.py's
#: defaults (50M rows, 50 rounds, bf16 then f32) on cpp/gen_libsvm.cc's
#: rows (seed 7), made on the card in blocks of LIN_BLOCK rows
LIN_ROWS = 50_000_000
LIN_FEATURES = 39
LIN_ROUNDS = 50
LIN_SEED = 7
LIN_BLOCK = 4_000_000
LIN_WARMUP = 3
#: the card against the CPU, and fit_iter over libsvm text, on slices
LIN_SLICE = 100_000
LIN_TEXT_ROWS = 50_000
#: the JAX package's bound between two f32 summation orders
LIN_RTOL, LIN_ATOL = 2e-4, 2e-6
#: fm: FM on the first FM_ROWS of those rows, one epoch
FM_ROWS = 10_000_000
FM_FACTORS = 8
FM_BATCH = 8192
FM_SLICE = 100_000
FM_HELD_OUT = 100_000
#: the JAX package's FM bound between two summation orders
FM_RTOL, FM_ATOL = 1e-3, 1e-4
#: sklearn: the wrappers on the card over the first SK_ROWS of those rows
SK_ROWS = 1_000_000
SK_TREES = 20
SK_SLICE = 20_000
SK_SPARSE_ROWS = 100_000
SK_MIN_ACC = 0.7
#: serve: the bucket ladder of the port bench's --serve
SERVE_MAX_BATCH = 256
SERVE_MIN_BUCKET = 8
SERVE_CLIENTS = 4
SERVE_PHASE_S = 1.5
SERVE_TIMEOUT = 300
#: tenancy: TENANTS HistGBT tenants (trees and depth their own) over a
#: resident cap of TENANT_CAP, Zipf(TENANT_ZIPF_A) traffic over HTTP
TENANTS = 12
TENANT_CAP = 4
TENANT_ZIPF_A = 1.1
TENANT_ROWS = 50_000
TENANT_MAX_BATCH = 64
TENANT_REQUESTS = 240
#: fleet: the port bench's --fleet models (v1 5 trees, v2 10, depth 4,
#: 32 bins, 20k rows) behind FLEET_REPLICAS in-process replicas
FLEET_REPLICAS = 3
FLEET_ROWS = 20_000
FLEET_MAX_BATCH = 64
FLEET_REQUESTS = 120
FLEET_TIMEOUT = 300
BENCH_ROUNDS = 100
BENCH_ROWS = 10_000_000
#: the stream phase: the stream bench's defaults (chunks of 1024 events,
#: a window of 2, 5 trees a refresh at depth 4 and 32 bins), the events
#: of the main run's shard, its refreshes, and the big refresh's chunk
STREAM_CHUNK = 1024
STREAM_WINDOW = 2
STREAM_KW = dict(n_trees=5, max_depth=4, n_bins=32, learning_rate=0.3)
STREAM_REFRESHES = 6
STREAM_EVENTS = STREAM_REFRESHES * STREAM_CHUNK
STREAM_BIG = 262_144
STREAM_TIMEOUT = 240
#: the ps phase: sparse CTR rows a worker over F hashed features, the
#: rows densified for the predict check, and the card-vs-CPU predict
#: tolerance (a matrix product on each: the same weights, other
#: summation orders)
PS_FEATURES = 20_000
PS_ROWS = 10_000
PS_PREDICT_ROWS = 2_000
PS_RTOL, PS_ATOL = 1e-5, 1e-5
PS_TIMEOUT = 240
#: the recovery phase's elastic run: rows, model, time limit
ELASTIC_ROWS = 200_000
ELASTIC_KW = dict(n_trees=6, max_depth=4, n_bins=32, learning_rate=0.3)
ELASTIC_TIMEOUT = 300
# resnet: (a) trainer steps on the card against the CPU from the same
# carried weights: the losses (relative), and the change of the
# parameters and of the BN running statistics over the steps (global
# norm of card − CPU over the CPU's change).  f32 (TF32 off): cuDNN's
# and the CPU's convolutions sum in other orders (1e-6 a layer), so
# losses and statistics to 1e-4, the micro models' updates to 1e-3.  A
# ReLU input within that rounding of 0 takes the other side of the mask
# on the other device: continuous in the forward, a whole gradient
# element in the backward.  ResNet-50's 6.3M ReLU inputs a step at
# 8 × 64² hold a few such elements, so its update is held to 0.1
# (measured 0.023 after two steps on the H100).  ``relu_sensitivity``
# prints the evidence beside the check: one step's gradients on the card
# with cuDNN and without, and on the CPU under a 1e-7 relative nudge of
# the weights, each against the CPU's, with the flipped ReLU inputs
# (ROADMAP C18).  Its statistics, which take in the second step's
# forward on those weights, to 1e-3 (measured 7.7e-5).
# bf16 rounds at other places in cuDNN and on the CPU, with more such
# flips: losses 2e-3, statistics 3e-3, updates 0.1 (measured 7.5e-5 /
# 3.9e-4, 8.8e-5 / 3.1e-4 and 0.013 / 0.043).  A
# wrong stride, pad or layout moves the first loss; a wrong backward
# moves the update by O(1) (at the first step all gradient runs through
# the shortcuts: each block's last BN starts at scale 0).  Each case:
# name, stage sizes, bottleneck, filters, side, batch, steps, and per
# dtype (loss rtol, statistics, update).  ResNet-50 runs f32 alone (the
# CPU's bf16 convolutions at its widths would outlast the phase).
RESNET_SEED = 5
RESNET_MICRO_CLASSES = 10
#: the relative nudge of the weights in ``relu_sensitivity``
RESNET_NUDGE = 1e-7
_MICRO_TOL = {"f32": (1e-4, 1e-4, 1e-3), "bf16": (2e-3, 3e-3, 0.1)}
RESNET_CROSS = (
    ("resnet-micro", (1, 1), False, 8, 32, 16, 3, _MICRO_TOL),
    ("bottleneck-micro", (1, 1), True, 8, 32, 16, 3, _MICRO_TOL),
    ("resnet50", (3, 4, 6, 3), True, 64, 64, 8, 2,
     {"f32": (1e-4, 1e-3, 0.1)}),
)
# submit: dmlc-submit's local cluster on the card.  The first 1M of
# configuration 1's HIGGS-like rows (seed 7) as %.9g libsvm text in 4
# shards (~0.4 GB), served from an S3 fake in this process (and on local
# disk); configuration 1's widths grown depth-wise (the external engine's
# chunked route, which several ranks take, is depth-wise whatever
# DMLC_GROW_POLICY says, as the JAX package's is); one set of cuts.
SUBMIT_ROWS = 1_000_000
SUBMIT_SHARDS = 4
SUBMIT_RANKS = 2
SUBMIT_LEVERS = {"DMLC_BIN_PACK": "1", "DMLC_FEATURE_BUNDLE": "1"}
SUBMIT_TIMEOUT = 600
# prodsim: the drill at its defaults (DMLC_PRODSIM_SECONDS 24)
PRODSIM_TIMEOUT = 600
# bench: the scaling probe's rows (its fits run on the host's CPU)
BENCH_PROBE_ROWS = 200_000


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
    BERT-base's non-causal shape (the main path's), and the Ulysses
    shard's results (with its ``shape``)."""
    entries = None
    for name, shape, causal in ATTN_SHAPES:
        res = check_attention(torch, A, name, shape, causal, rates, tc_rate)
        for kname, case in res.items():
            emit({"phase": "attention_kernels", "name": kname,
                  "shape": name, "B_S_H_D": list(shape), "causal": causal,
                  **case})
        if name == "bert":
            entries = res
        if name == "ulysses":
            ulysses = {k: {**v, "shape": shape} for k, v in res.items()}
    # SDPA's backward computes dq, dk and dv in one call: it stands beside
    # each backward kernel as the time of the whole backward
    for kname in ("flash_bwd_dkv", "flash_bwd_dq"):
        entries[kname]["library_call"] = "sdpa backward (dq, dk, dv)"
    entries["flash_fwd"]["library_call"] = "sdpa forward"
    return entries, ulysses


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
    return launches, first


def phase_bert_parallel(torch, np, A, smi, first_loss):
    """BERT's parallel axes at BERT-base width.  (a) one rank on a mesh
    naming every axis at size 1 (its ``seq`` axis takes ring attention,
    as JAX's does): the first loss within ``LOSS_RTOL`` of the ``bert``
    phase's; (b) two gloo ranks sharing the card on each of
    ``BERT_PAR_RUNS``, ``BERT_PAR_STEPS`` steps each, held to one rank's
    run from the same weights (losses within ``LOSS_RTOL``, gathered
    weights within ``PARAM_ATOL``), the flash kernels' launches counted
    on the Ulysses run.  Returns those launches."""
    from dmlc_core_tpu_torch.models import BERT, BERTParam
    from dmlc_core_tpu_torch.parallel.launch import run_ranks
    from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    t0 = time.perf_counter()
    model = BERT(mesh=create_mesh(MeshSpec(data=1)), device=DEVICE,
                 **BERT_PAR_KW)
    model.init_params(0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, model.param.vocab_size,
                          size=(BERT_BATCH, BERT_SEQ))
    loss = model.train_step(tokens, tokens.copy(),
                            np.ones(tokens.shape, np.float32))
    rel = abs(loss - first_loss) / abs(first_loss)
    require(rel <= LOSS_RTOL, f"bert_parallel (a): loss {loss} vs the bert "
            f"phase's {first_loss}")
    emit({"phase": "bert_parallel", "part": "a", "mesh": model.mesh.shape,
          "loss": loss, "bert_phase_loss": first_loss, "loss_rel_diff": rel,
          "seconds": time.perf_counter() - t0})
    del model
    gc_cuda(torch)
    runs = [{"name": name, "mesh": mesh, "bert": kw, "seed": 0,
             "steps": BERT_PAR_STEPS} for name, mesh, kw in BERT_PAR_RUNS]
    with tempfile.TemporaryDirectory() as d:
        job = {"threads": 4, "bert": BERT_PAR_KW,
               "device": "cuda:0" if DEVICE == "cuda" else DEVICE,
               "batch": {"seed": 0, "B": BERT_BATCH, "S": BERT_SEQ},
               "reference": True, "runs": runs, "out": d}
        path = os.path.join(d, "job.json")
        with open(path, "w") as f:
            json.dump(job, f)
        t0 = time.perf_counter()
        run_ranks([sys.executable, "-m",
                   "dmlc_core_tpu_torch.tools.bert_mesh", path],
                  BERT_PAR_RANKS, BERT_PAR_TIMEOUT, d)
        wall = time.perf_counter() - t0
        recs = {}
        for run in runs:
            with open(os.path.join(d, f"{run['name']}.json")) as f:
                recs[run["name"]] = json.load(f)
    p = BERTParam(**BERT_PAR_KW)
    for name, rec in recs.items():
        require(rec["finite"], f"bert_parallel {name}: non-finite values")
        require(rec["loss_max_rel_diff"] <= LOSS_RTOL,
                f"bert_parallel {name}: losses {rec['losses']} vs one "
                f"rank's {rec['ref_losses']}")
        require(rec["param_max_abs_diff"] <= PARAM_ATOL,
                f"bert_parallel {name}: weights off one rank's by "
                f"{rec['param_max_abs_diff']}")
        want = p.n_layers * BERT_PAR_STEPS if name == "seq2_ulysses" else 0
        for kname, n in rec["launches"].items():
            require(n == want, f"bert_parallel {name}: {kname} launched "
                    f"{n} times, want {want}")
        emit({"phase": "bert_parallel", "part": "b", **rec,
              "note": "two gloo ranks sharing one card, collectives "
                      "staged through host memory: not a scaling "
                      "measurement", "card": smi})
    emit({"phase": "bert_parallel", "part": "b", "ranks": BERT_PAR_RANKS,
          "runs": len(runs), "wall_seconds": wall})
    return recs["seq2_ulysses"]["launches"]


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
    rounds that went through the kernels, with the scaling probe's
    ``scaling`` (8 gloo ranks of the host at ``BENCH_PROBE_ROWS`` rows)
    or the budget note that skipped it."""
    drop = set(LEVER_NAMES) | {"DMLC_TPU_ROUNDS_PER_DISPATCH",
                               "DMLC_TPU_BIN_BACKEND", "BENCH_FORCE_CPU"}
    env = {k: v for k, v in os.environ.items()
           if k not in drop and not k.startswith("BENCH_")}
    # the flagship size or a failure: no quiet drop to fewer rows
    env["BENCH_NO_FALLBACK"] = "1"
    env["BENCH_PROBE_ROWS"] = str(BENCH_PROBE_ROWS)
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
    kvs = rec.get("kvstore_sync_ms") or {}
    require(isinstance(kvs.get("value"), float) and kvs["value"] > 0,
            f"bench: kvstore_sync_ms {rec.get('kvstore_sync_ms')}")
    scaling = rec.get("scaling") or {}
    require(scaling.get("scaling_efficiency", 0) > 0
            or any("scaling probe skipped" in n
                   for n in rec.get("notes", [])),
            f"bench: no scaling probe ({rec.get('scaling')}, "
            f"{rec.get('notes')})")
    phases = {}
    for ln in lines:
        r = json.loads(ln)
        phases.setdefault(r["phase"], r["elapsed_s"])
    keys = ("value", "value_basis", "rounds_per_sec_median_chunk",
            "rounds_per_sec_best_chunk", "chunk_seconds_per_round",
            "seconds", "warmup_seconds", "warm_dispatch_seconds",
            "infeed_stall_frac", "kvstore_sync_ms",
            "warmup_breakdown", "compile_seconds", "compile_cache",
            "bin_seconds", "time_to_first_tree", "kernel", "rows",
            "features", "rounds", "levers", "device_kind", "nvidia_smi",
            "hbm_gbps", "scaling", "notes")
    emit({"phase": "bench", **{k: rec.get(k) for k in keys},
          "phase_elapsed_s": phases, "child_wall_seconds": wall})
    return rec


# ---------------------------------------------------------------------------
# the other boosters and the serving tier
# ---------------------------------------------------------------------------

def criteo_like(torch, np, n, F, seed, block=LIN_BLOCK):
    """``cpp/gen_libsvm.cc``'s rows, vectorised with torch on ``DEVICE``:
    row ``r``'s state is ``splitmix64(seed · 0x100000001b3 + r)``, one
    more ``splitmix64`` step a feature; ``(s & 31) == 0`` is missing (0,
    as a densified page has it), else the fixed-point draw ``v = (s >> 40
    & 0x7ff) − 1024`` gives the value the generator prints (``v / 128``
    toward zero, then two decimals of ``|v| % 128 · 100 / 128``) as the
    float32 its text parses to (``-0.00`` is ``-0.0``); the label is
    ``v0·v1 + 256·v2 > 0`` over the first three draws (0 where missing).
    uint64 arithmetic in int64 tensors (adds and products wrap alike,
    right shifts masked to logical ones), ``block`` rows at a time into
    host arrays: no ``[n, F]`` 64-bit temporary anywhere.
    ``tests/test_torch_linear.py`` holds these rows bit for bit against
    the compiled generator's text."""
    dev = torch.device(DEVICE)

    def c64(x):                        # a uint64 constant as int64 bits
        return x - (1 << 64) if x >= 1 << 63 else x

    def shr(x, k):
        return (x >> k) & ((1 << (64 - k)) - 1)

    def mix(x):
        x = x + c64(0x9E3779B97F4A7C15)
        x = (x ^ shr(x, 30)) * c64(0xBF58476D1CE4E5B9)
        x = (x ^ shr(x, 27)) * c64(0x94D049BB133111EB)
        return x ^ shr(x, 31)

    X = np.empty((n, F), np.float32)
    y = np.empty(n, np.float32)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        s = mix(torch.arange(lo, hi, dtype=torch.int64, device=dev)
                + seed * 0x100000001B3)
        out = torch.empty((hi - lo, F), dtype=torch.float32, device=dev)
        first = []
        for j in range(F):
            s = mix(s)
            v = torch.where((s & 31) != 0, (shr(s, 40) & 0x7FF) - 1024, 0)
            a = v.abs()
            mag = ((a // 128) * 100 + (a % 128) * 100 // 128).double() / 100
            out[:, j] = torch.where(v < 0, -mag, mag)   # "-0.00" is -0.0
            if j < 3:
                first.append(v)
        X[lo:hi] = out.cpu().numpy()
        y[lo:hi] = (first[0] * first[1] + 256 * first[2] > 0).cpu().numpy()
    return X, y


def logloss(np, p, y) -> float:
    p = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def gc_cuda(torch):
    """Free what the caching allocator holds (for a peak measured from
    a clean base)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_linear(torch, np, smi):
    """``GBLinear`` at Criteo's width (``criteo_like``: ``LIN_ROWS`` ×
    ``LIN_FEATURES``), ``LIN_ROUNDS`` rounds, bf16 then f32: rounds/s from
    the chunk evidence, the fit's peak device memory held below X's bytes
    plus the labels and row weights, three upload slabs (the one being
    cast, the one in flight, one awaiting reuse) and one row block's
    temporaries; ``fit_iter`` over ``LIN_TEXT_ROWS`` rows of libsvm text
    (``RowBlockIter.create``) equal to ``fit`` on the same rows; the
    card's weights against the CPU's on ``LIN_SLICE`` rows; ``save_model``
    → ``load_model`` giving the same predictions.  Returns the rows and
    the bf16 model."""
    from dmlc_core_tpu_torch.data.iter import RowBlockIter
    from dmlc_core_tpu_torch.models import GBLinear
    from dmlc_core_tpu_torch.models import linear as L

    t0 = time.perf_counter()
    X, y = criteo_like(torch, np, LIN_ROWS, LIN_FEATURES, LIN_SEED)
    gen_s = time.perf_counter() - t0
    n, F = X.shape
    fits, models = {}, {}
    for dtype in ("bfloat16", "float32"):
        gc_cuda(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m = GBLinear(device=DEVICE, n_rounds=LIN_ROUNDS,
                     objective="binary:logistic", feature_dtype=dtype)
        t0 = time.perf_counter()
        m.fit(X, y, warmup_rounds=LIN_WARMUP)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        x_bytes = n * F * (2 if dtype == "bfloat16" else 4)
        allowed = (x_bytes + 2 * n * 4          # X, labels, row weights
                   + 3 * L._UPLOAD_ROWS * F * 4  # f32 slabs going up
                   + 2 * L._BLOCK_ROWS * F * 4  # a block and its square
                   + 16 * L._BLOCK_ROWS * 4     # margin, g, h, their f64
                   + (64 << 20))                # small tensors, rounding
        require(peak <= allowed, f"linear {dtype}: peak device memory "
                f"{peak} above its bound {allowed}")
        require(np.isfinite(m.weights).all(), f"linear {dtype}: weights")
        ct = m.last_chunk_times
        require([d for d, _ in ct] == [25, 50],
                f"linear {dtype}: chunk evidence {ct}")
        acc = float(((m.predict(X[:1_000_000]) > 0.5)
                     == (y[:1_000_000] > 0.5)).mean())
        fits[dtype] = {
            "fit_wall_seconds": wall,
            "upload_seconds": wall - m.last_fit_seconds
            - m.last_warmup_seconds,
            "warmup_seconds": m.last_warmup_seconds,
            "fit_seconds": m.last_fit_seconds,
            "rounds_per_sec": LIN_ROUNDS / m.last_fit_seconds,
            "chunk_rounds_per_sec": [
                (d - d0) / (t - t0_) for (d0, t0_), (d, t) in
                zip([(0, 0.0)] + ct[:-1], ct)],
            "chunk_times": ct, "peak_device_bytes": peak,
            "peak_bound_bytes": allowed, "x_device_bytes": x_bytes,
            "train_accuracy_first_1M": acc}
        models[dtype] = m
    bf, f32 = models["bfloat16"], models["float32"]
    # the JAX package's bf16-against-f32 oracle bound (tests/test_linear.py)
    require(np.all(np.abs(bf.weights - f32.weights)
                   <= 0.02 + 0.05 * np.abs(f32.weights)),
            "linear: bf16 weights far from the f32 fit's")
    # the card against the CPU, and fit_iter over libsvm text
    s = slice(0, LIN_SLICE)
    cross = {}
    for dtype in ("bfloat16", "float32"):
        a = GBLinear(device=DEVICE, n_rounds=LIN_ROUNDS,
                     feature_dtype=dtype).fit(X[s], y[s])
        b = GBLinear(device="cpu", n_rounds=LIN_ROUNDS,
                     feature_dtype=dtype).fit(X[s], y[s])
        err = float(np.max(np.abs(a.weights - b.weights)
                           / (LIN_ATOL + LIN_RTOL * np.abs(b.weights))))
        require(err <= 1.0 and abs(a.bias - b.bias)
                <= LIN_ATOL + LIN_RTOL * abs(b.bias),
                f"linear {dtype}: card and CPU weights differ "
                f"({err} of the tolerance)")
        cross[dtype] = err
    t = slice(0, LIN_TEXT_ROWS)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "criteo.libsvm")
        t0 = time.perf_counter()
        write_libsvm(np, path, X[t], y[t])
        it = RowBlockIter.create(path, 0, 1, "libsvm")
        streamed = GBLinear(device=DEVICE, n_rounds=LIN_ROUNDS,
                            feature_dtype="bfloat16").fit_iter(
            it, num_col=F, rows_per_upload=16_384)
        it.close()
        text_s = time.perf_counter() - t0
        dense = GBLinear(device=DEVICE, n_rounds=LIN_ROUNDS,
                         feature_dtype="bfloat16").fit(X[t], y[t])
        require(np.array_equal(streamed.weights, dense.weights)
                and streamed.bias == dense.bias,
                "linear: fit_iter over libsvm text != fit on the rows")
        mpath = os.path.join(d, "lin.model")
        bf.save_model(mpath)
        again = GBLinear.load_model(mpath, device=DEVICE)
        require(np.array_equal(again.predict(X[s]), bf.predict(X[s])),
                "linear: load_model predictions differ")
    emit({"phase": "linear", "card": smi, "rows": n, "features": F,
          "rounds": LIN_ROUNDS, "missing_share": float((X == 0).mean()),
          "positive_share": float(y.mean()), "gen_seconds": gen_s,
          "fits": fits, "block_rows": L._BLOCK_ROWS,
          "card_vs_cpu_slice": LIN_SLICE,
          "card_vs_cpu_err_of_tolerance": cross,
          "fit_iter_text_rows": LIN_TEXT_ROWS,
          "fit_iter_text_seconds": text_s, "fit_iter_equals_fit": True,
          "load_model_equal": True})
    return X, y, bf


def phase_fm(torch, np, smi, X, y):
    """``FM`` (k = ``FM_FACTORS``, ``batch_size`` ``FM_BATCH``) on the
    first ``FM_ROWS`` Criteo-like rows, one epoch: steps/s, the held-out
    logloss falling from the initial state's; the card against the CPU on
    ``FM_SLICE`` rows; ``save_model`` → ``load_model`` → one more epoch
    on the card equal to the saved model's own next epoch.  Returns the
    model."""
    from dmlc_core_tpu_torch.models import FM

    F = X.shape[1]
    hold = slice(FM_ROWS, FM_ROWS + FM_HELD_OUT)
    m = FM(device=DEVICE, n_factors=FM_FACTORS, batch_size=FM_BATCH,
           n_epochs=1)
    m._init_state(F)
    before = logloss(np, m.predict(X[hold]), y[hold])
    t0 = time.perf_counter()
    m.fit(X[:FM_ROWS], y[:FM_ROWS])
    wall = time.perf_counter() - t0
    after = logloss(np, m.predict(X[hold]), y[hold])
    steps = -(-FM_ROWS // FM_BATCH)
    require(int(m._opt["t"]) == steps, f"fm: {int(m._opt['t'])} steps")
    require(after < before, f"fm: held-out logloss {before} -> {after}")
    s = slice(0, FM_SLICE)
    kw = dict(n_factors=FM_FACTORS, batch_size=FM_BATCH, n_epochs=1)
    a = FM(device=DEVICE, **kw).fit(X[s], y[s])
    b = FM(device="cpu", **kw).fit(X[s], y[s])
    cross = {}
    for k in ("w0", "w", "v"):
        pa, pb = a.params[k].cpu().numpy(), b.params[k].cpu().numpy()
        cross[k] = float(np.max(np.abs(pa - pb)
                                / (FM_ATOL + FM_RTOL * np.abs(pb))))
        require(cross[k] <= 1.0, f"fm: card and CPU {k} differ "
                f"({cross[k]} of the tolerance)")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fm.model")
        a.save_model(path)
        again = FM.load_model(path, device=DEVICE)
    require(int(again._opt["t"]) == int(a._opt["t"]), "fm: step not kept")
    again.fit(X[s], y[s])
    a.fit(X[s], y[s])
    # the same ops on the same inputs: bit for bit, the Adam state too
    resume = max(float((again.params[k] - a.params[k]).abs().max())
                 for k in a.params)
    require(all(torch.equal(again.params[k], a.params[k])
                and torch.equal(again._opt["m"][k], a._opt["m"][k])
                and torch.equal(again._opt["s"][k], a._opt["s"][k])
                for k in a.params)
            and int(again._opt["t"]) == int(a._opt["t"]),
            f"fm: the loaded model resumed elsewhere ({resume})")
    emit({"phase": "fm", "card": smi, "rows": FM_ROWS, "features": F,
          "factors": FM_FACTORS, "batch_size": FM_BATCH, "epochs": 1,
          "steps": steps, "fit_seconds": m.last_fit_seconds,
          "fit_wall_seconds": wall,
          "steps_per_sec": steps / m.last_fit_seconds,
          "rows_per_sec": FM_ROWS / m.last_fit_seconds,
          "heldout_logloss_before": before, "heldout_logloss_after": after,
          "last_batch_loss": m.last_loss, "card_vs_cpu_slice": FM_SLICE,
          "card_vs_cpu_err_of_tolerance": cross,
          "resume_max_abs_diff": resume})
    return m


def phase_sklearn(torch, np, smi, X, y):
    """The sklearn wrappers on the card: ``GBTClassifier`` with
    ``booster="gbtree"`` and ``"gblinear"`` on the first ``SK_ROWS``
    Criteo-like rows, and the sparse route (``SparseHistGBT``) on a scipy
    CSR of the first ``SK_SPARSE_ROWS`` (absent entries missing): held-out
    accuracy, probabilities; on ``SK_SLICE`` rows the card's booster file
    equal to the CPU's (tree boosters) or its weights within
    ``GBLinear``'s tolerance.  Returns the sparse model."""
    import scipy.sparse as sps

    from dmlc_core_tpu_torch.models import GBTClassifier

    hv = slice(SK_ROWS, SK_ROWS + 100_000)
    out = {}
    cases = {"gbtree": dict(max_depth=MAX_DEPTH, n_bins=N_BINS),
             "gblinear": {},
             "sparse": dict(max_depth=MAX_DEPTH, n_bins=32)}
    sparse_model = None
    for name, kw in cases.items():
        booster = "gblinear" if name == "gblinear" else "gbtree"
        rows = SK_SPARSE_ROWS if name == "sparse" else SK_ROWS

        def data(sl):
            return sps.csr_matrix(X[sl]) if name == "sparse" else X[sl]

        est = GBTClassifier(booster=booster, n_estimators=SK_TREES,
                            device=DEVICE, **kw)
        t0 = time.perf_counter()
        est.fit(data(slice(0, rows)), y[:rows].astype(int))
        fit_s = time.perf_counter() - t0
        require(est.model.device == torch.device(DEVICE)
                or est.model.device.type == DEVICE,
                f"sklearn {name}: booster on {est.model.device}")
        proba = est.predict_proba(data(hv))
        require(proba.shape == (100_000, 2) and np.allclose(
            proba.sum(1), 1.0, atol=1e-6), f"sklearn {name}: proba")
        acc = est.score(data(hv), y[hv].astype(int))
        if booster == "gbtree":
            require(acc > SK_MIN_ACC, f"sklearn {name}: held-out accuracy "
                    f"{acc}")
        sl = slice(0, SK_SLICE)
        pair = [GBTClassifier(booster=booster, n_estimators=SK_TREES,
                              device=dev, **kw).fit(
            data(sl), y[sl].astype(int)) for dev in (DEVICE, "cpu")]
        if booster == "gbtree":
            same = model_bytes_of(pair[0].model) == model_bytes_of(
                pair[1].model)
            require(same, f"sklearn {name}: the card's file != the CPU's")
        else:
            wa, wb = pair[0].model.weights, pair[1].model.weights
            same = bool(np.all(np.abs(wa - wb)
                               <= LIN_ATOL + LIN_RTOL * np.abs(wb)))
            require(same, f"sklearn {name}: card and CPU weights differ")
        if name == "sparse":
            sparse_model = est.model
        out[name] = {"rows": rows, "fit_seconds": fit_s,
                     "heldout_accuracy": acc, "card_equals_cpu": same,
                     "booster": type(est.model).__name__}
    emit({"phase": "sklearn", "card": smi, "trees": SK_TREES,
          "card_vs_cpu_slice": SK_SLICE, **out})
    return sparse_model


def check_descend_serve(torch, H, model, rows, rates):
    """``descend_kernel`` (B2's descend, no direction) at a served batch's
    shapes: the batch's bins ``[F, b]`` at every level of every tree of
    ``model`` (the node ids of the real descend), against
    ``descend_plain``, twice over; then the deepest level timed beside
    its bound (the bin byte, the node id in and out: 9 bytes a row, plus
    the tables)."""
    dev = torch.device(DEVICE)
    bins = model._bins_of(torch.from_numpy(rows).to(dev))
    st = model._stacked_trees(model.trees)
    F, n = bins.shape
    err = 0.0
    for t in range(st["feat"].shape[0]):
        node = torch.zeros(n, dtype=torch.int32, device=dev)
        for lv in range(MAX_DEPTH):
            feat = st["feat"][t, lv].to(torch.int32).contiguous()
            thr = st["thr"][t, lv].to(torch.int32).contiguous()
            a = H.descend_kernel(bins, node, feat, thr, True)
            b = H.descend_kernel(bins, node, feat, thr, True)
            c = H.descend_plain(bins, node, feat, thr, True)
            require(torch.equal(a, c) and torch.equal(a, b),
                    f"descend_kernel != plain (tree {t}, level {lv})")
            err = max(err, max_abs_err(torch, a, c))
            last = (node, feat, thr)
            node = a
    node, feat, thr = last
    n_prev = 1 << (MAX_DEPTH - 1)
    nbytes = n + 4 * n + 4 * n + 8 * n_prev
    b_ms, b_by = bound(nbytes, n, rates)
    return {"rows": n, "F": F, "n_prev": n_prev,
            "ms": time_ms(torch, lambda: H.descend_kernel(
                bins, node, feat, thr, True), REPS, inner=10),
            "plain_ms": time_ms(torch, lambda: H.descend_plain(
                bins, node, feat, thr, True), REPS, inner=10),
            "device_ms": device_ms(torch, lambda: H.descend_kernel(
                bins, node, feat, thr, True), 10 * REPS),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": err, "bytes": nbytes}


def serve_http(np, registry, direct, Xv, swap):
    """The frontend end to end: ``SERVE_CLIENTS`` threads post random
    slices of ``Xv`` (1..16 rows) for ``SERVE_PHASE_S`` seconds, ``swap()``
    publishes the next version under that traffic, ``SERVE_PHASE_S`` more
    seconds.  Returns the frontend's batches and, per response,
    ``(version, rows bit-identical to that version's predict)``."""
    import threading

    from dmlc_core_tpu_torch.base.metrics import default_registry
    from dmlc_core_tpu_torch.serve import ResilientClient, ServeFrontend

    hist = default_registry().histogram("serve_batch_rows",
                                        labels=("batcher",))
    out, errors, stop = [], [], threading.Event()
    lock = threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        c = ResilientClient(fe.url)
        while not stop.is_set():
            k = int(rng.integers(1, 17))
            lo = int(rng.integers(0, len(Xv) - k))
            try:
                got, version = c.predict(Xv[lo:lo + k])
            except Exception as e:  # noqa: BLE001 — counted, then failed
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:200])
                continue
            # a version the script did not publish is a wrong answer
            ok = (version in direct and got.tobytes()
                  == direct[version][lo:lo + k].tobytes())
            with lock:
                out.append((version, ok))

    batches0 = hist.count(batcher=registry.name)
    with ServeFrontend(registry, max_batch=SERVE_MAX_BATCH,
                       max_delay=0.002, max_queue=512) as fe:
        threads = [threading.Thread(target=client, args=(100 + i,))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(SERVE_PHASE_S)
        swap()
        time.sleep(SERVE_PHASE_S)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    require(not errors, f"serve: failed requests {errors[:3]}")
    return hist.count(batcher=registry.name) - batches0, out


def phase_serve(torch, np, H, rates, smi, Xv, lossguide_bytes, main_model,
                others):
    """The serving tier on the card: configuration 1's model (phase
    ``main_lossguide``'s file) published to a ``ModelRegistry`` and its
    ladder (``SERVE_MIN_BUCKET``..``SERVE_MAX_BATCH``) warmed; at every
    bucket (full and partly padded) the served predictions bit-identical
    to ``model.predict`` and to the CPU's ``predict`` of the same file,
    ``descend_kernel`` launched trees × depth times a batch; the kernel
    held against its plain version at a served batch's shapes; the HTTP
    frontend end to end with a hot swap to phase ``main``'s model, each
    response bit-identical to the version it reports, the launch counts
    set to 0 just before and read just after; ``others`` (GBLinear, FM,
    SparseHistGBT on the card) through ``ModelRunner``, bit-identical to
    their ``predict``; then the port bench's ``--serve`` as a child
    process at its defaults.  Returns the
    ``descend`` kernels entry and its launches on the HTTP path."""
    from dmlc_core_tpu_torch.serve import ModelRegistry, model_from_bytes
    from dmlc_core_tpu_torch.serve.runner import ModelRunner, _dense_as_csr

    model = model_from_bytes(lossguide_bytes, device=DEVICE)
    cpu = model_from_bytes(lossguide_bytes, device="cpu")
    registry = ModelRegistry(name="chip-serve", device=DEVICE,
                             max_batch=SERVE_MAX_BATCH,
                             min_bucket=SERVE_MIN_BUCKET)
    v1 = registry.publish(model, source="main_lossguide")
    runner = registry.get(v1)
    warm_s = runner.warmup()
    ladder = [SERVE_MIN_BUCKET << i for i in range(runner.shape_bound)]
    require(sorted(runner.compiled_shapes) == ladder,
            f"serve: warmed {sorted(runner.compiled_shapes)}")
    per_batch = TREES * MAX_DEPTH
    buckets = {}
    for b in ladder:
        for k in (b, b - b // 4 - 1):
            rows = Xv[1000:1000 + k]
            H.descend_kernel.launches = 0
            H.descend_kernel.dir_launches = 0
            got = runner.predict(rows)
            launches = H.descend_kernel.launches
            require(launches == per_batch
                    and H.descend_kernel.dir_launches == 0,
                    f"serve: {launches} descend launches for a batch of "
                    f"{k} rows, want {per_batch}")
            require(got.tobytes() == model.predict(rows).tobytes(),
                    f"serve: bucket {b} ({k} rows) != model.predict")
            require(got.tobytes() == cpu.predict(rows).tobytes(),
                    f"serve: bucket {b} ({k} rows) != the CPU's predict")
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            runner.predict(Xv[:b])
            times.append((time.perf_counter() - t0) * 1e3)
        buckets[b] = statistics.median(times)
    entry = check_descend_serve(torch, H, model, Xv[:SERVE_MAX_BATCH], rates)
    emit({"phase": "kernel", "name": "descend", **entry})
    direct = {1: model.predict(Xv), 2: main_model.predict(Xv)}
    require(direct[1].tobytes() != direct[2].tobytes(),
            "serve: the two versions predict alike")
    H.descend_kernel.launches = 0
    H.descend_kernel.dir_launches = 0
    batches, answers = serve_http(
        np, registry, direct, Xv,
        lambda: registry.publish(main_model, source="main"))
    launches = H.descend_kernel.launches
    require(H.descend_kernel.dir_launches == 0,
            "serve: direction-mode descends on the serve path")
    require(launches == per_batch * batches and batches > 0,
            f"serve: {launches} descend launches for {batches} batches")
    versions = sorted({v for v, _ in answers})
    require(versions == [1, 2], f"serve: versions answered {versions}")
    require(all(ok for _, ok in answers), "serve: a response differs from "
            "the predict of the version it reports")
    fam = {}
    for name, (m, rows) in others.items():
        r = ModelRunner(m, max_batch=SERVE_MAX_BATCH,
                        min_bucket=SERVE_MIN_BUCKET, name=name)
        r.warmup()
        x = rows[:100]
        got = r.predict(x)
        want = (m.predict(*_dense_as_csr(x)) if name == "sparse"
                else m.predict(x))
        require(got.tobytes() == want.tobytes(),
                f"serve: {name} runner != predict")
        fam[name] = {"compiled_shapes": sorted(r.compiled_shapes),
                     "max_abs_diff": float(np.max(np.abs(got - want)))}
    bench = phase_serve_bench(np)
    emit({"phase": "serve", "card": smi, "trees": TREES,
          "max_depth": MAX_DEPTH, "ladder": ladder, "warmup_seconds": warm_s,
          "bucket_predict_ms": buckets,
          "descend_launches_per_batch": per_batch,
          "http_batches": batches, "http_responses": len(answers),
          "http_descend_launches": launches,
          "http_versions": versions, "families": fam,
          "descend_kernel_ms": entry["ms"],
          "descend_kernel_device_ms": entry["device_ms"],
          "bench": bench})
    return entry, launches


def bench_child(mode, metric, timeout):
    """``python -m dmlc_core_tpu_torch.bench <mode>`` at its defaults as a
    child process; its last line must be the mode's final record, on this
    run's platform, with no error.  Returns the record, with the child's
    wall seconds."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SERVE_", "FLEET_", "TENANTS_",
                                "STREAM_"))
           and k != "DMLC_TPU_ROUNDS_PER_DISPATCH"}
    platform = "cpu" if DEVICE == "cpu" else "gpu"
    if platform == "cpu":          # a rehearsal of the script on the host
        env["BENCH_FORCE_CPU"] = "1"
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          mode], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    require(res.returncode == 0 and lines,
            f"bench {mode} exited {res.returncode}: {res.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    require(rec.get("metric") == metric
            and rec.get("provisional") is False and "error" not in rec
            and rec.get("platform") == platform,
            f"bench {mode}: bad record {lines[-1][:500]}")
    rec.pop("metrics_summary", None)
    rec["child_wall_seconds"] = wall
    return rec


def phase_serve_bench(np):
    """``python -m dmlc_core_tpu_torch.bench --serve`` at its defaults as
    a child process; its last line must be a final record with completed
    requests, latency percentiles, buckets within the bound and
    ``descend_kernel`` trees × depth launches a batch."""
    platform = "cpu" if DEVICE == "cpu" else "gpu"
    rec = bench_child("--serve", "serve_requests_per_sec", SERVE_TIMEOUT)
    require(rec["completed"] > 0 and rec["latency_p99_ms"] is not None,
            f"bench --serve: {json.dumps(rec)[:500]}")
    require(rec["compiled_shapes"]
            and len(rec["compiled_shapes"]) <= rec["shape_bound"],
            f"bench --serve: shapes {rec['compiled_shapes']}")
    require(platform == "cpu" or rec["descend_launches_per_batch"]
            == rec["descend_launches_per_batch_expected"],
            f"bench --serve: {rec.get('descend_launches_per_batch')} "
            "descend launches a batch")
    return rec


def restore_stats(names):
    """Per tenant: (page-ins, their wall seconds) so far, from the
    registry's ``tenant_restore_seconds`` histogram."""
    from dmlc_core_tpu_torch.base.metrics import default_registry

    h = default_registry().histogram("tenant_restore_seconds",
                                     labels=("tenant",))
    return {n: (h.count(tenant=n), h.sum(tenant=n)) for n in names}


def phase_tenancy(torch, np, H, smi):
    """Multi-tenant serving on the card through the frontend's
    ``tenants=`` seam (see the module docstring, 12g).  Returns the
    ``descend_kernel`` launches of its HTTP run."""
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.serve import (ModelRegistry, ResilientClient,
                                           ServeFrontend, model_from_bytes,
                                           model_to_bytes)
    from dmlc_core_tpu_torch.serve.fleet.loadgen import (sample_tenant,
                                                         zipf_weights)
    from dmlc_core_tpu_torch.serve.tenancy import TenantRegistry

    X, _ = higgs_like(np, TENANT_ROWS, FEATURES, 21)
    Xs = X[:TENANT_MAX_BATCH * 8]
    names = [f"t{i:02d}" for i in range(TENANTS)]
    reg = TenantRegistry(resident_cap=TENANT_CAP, device=DEVICE,
                         max_batch=TENANT_MAX_BATCH, min_bucket=8)
    expected, per_batch, fit_s = {}, {}, 0.0
    for i, name in enumerate(names):
        trees, depth = 3 + i % 4, 3 + (i // 4 + i) % 4
        y = (X[:, i % FEATURES] + 0.5 * X[:, (i + 1) % FEATURES]
             > 0).astype(np.float32)
        t0 = time.perf_counter()
        m = HistGBT(n_trees=trees, max_depth=depth, n_bins=64,
                    learning_rate=0.3, device=DEVICE).fit(X, y)
        fit_s += time.perf_counter() - t0
        card = m.predict(Xs)
        cpu = model_from_bytes(model_to_bytes(m), device="cpu").predict(Xs)
        require(card.tobytes() == cpu.tobytes(),
                f"tenancy {name}: card and CPU predict differ")
        expected[name] = card
        per_batch[name] = trees * depth
        reg.publish(name, m)
        del m
    gc_cuda(torch)
    require(len(reg.resident()) == TENANT_CAP and reg.evictions > 0,
            f"tenancy: resident {reg.resident()} after publishing")
    mem_full = torch.cuda.memory_allocated()
    ladder = reg.current(names[-1])[1].shape_bound
    cum = zipf_weights(TENANTS, TENANT_ZIPF_A)
    rng = np.random.default_rng(23)
    probe = Xs[:16]
    evict0, restore0 = reg.evictions, reg.restores
    pages0 = restore_stats(names)
    answers, lats, before = [], [], {}
    single = ModelRegistry(name="chip-tenancy", device=DEVICE,
                           max_batch=TENANT_MAX_BATCH)
    H.descend_kernel.launches = 0
    H.descend_kernel.dir_launches = 0
    with ServeFrontend(single, max_batch=TENANT_MAX_BATCH,
                       tenants=reg) as fe:
        client = ResilientClient(fe.url)
        for name in names:          # each tenant's probe: 12 page-ins
            before[name] = client.predict(probe, tenant=name)
        for _ in range(TENANT_REQUESTS):
            name = sample_tenant(rng, names, cum)
            k = int(rng.integers(1, TENANT_MAX_BATCH + 1))
            lo = int(rng.integers(0, len(Xs) - k + 1))
            t0 = time.perf_counter()
            got, version = client.predict(Xs[lo:lo + k], tenant=name)
            lats.append(time.perf_counter() - t0)
            answers.append((name, version, got.tobytes()
                            == expected[name][lo:lo + k].tobytes()))
        after = {name: client.predict(probe, tenant=name)
                 for name in names}
    launches = H.descend_kernel.launches
    pages = restore_stats(names)
    gc_cuda(torch)
    mem_after = torch.cuda.memory_allocated()
    require(H.descend_kernel.dir_launches == 0,
            "tenancy: direction-mode descends on the serve path")
    require(all(ok and v == 1 for _, v, ok in answers),
            "tenancy: a response differs from its tenant's predict")
    for name in names:
        require(before[name][0].tobytes() == after[name][0].tobytes()
                == expected[name][:16].tobytes(),
                f"tenancy {name}: probe answered differently")
    evictions = reg.evictions - evict0
    restores = reg.restores - restore0
    require(evictions > 0 and restores > 0,
            f"tenancy: {evictions} evictions, {restores} restores")
    n_pages = {n: pages[n][0] - pages0[n][0] for n in names}
    require(sum(n_pages.values()) == restores,
            f"tenancy: {n_pages} page-ins, {restores} restores")
    served = {n: 2 for n in names}           # the two probes
    for name, _, _ in answers:
        served[name] += 1
    want = sum(served[n] * per_batch[n] + n_pages[n] * per_batch[n] * ladder
               for n in names)
    require(launches == want, f"tenancy: {launches} descend launches, want "
            f"{want} (trees x depth a batch, x {ladder} a page-in)")
    page_s = sum(pages[n][1] - pages0[n][1] for n in names)
    bench = bench_child("--tenants", "tenant_requests_per_sec",
                        SERVE_TIMEOUT)
    require(bench["wrong"] == 0 and bench["requests"] > 0
            and bench["evictions"] > 0 and bench["warm_restores"] > 0,
            f"bench --tenants: {json.dumps(bench)[:500]}")
    require(DEVICE == "cpu" or bench["descend_launches"] > 0,
            "bench --tenants: no descend launches")
    emit({"phase": "tenancy", "card": smi, "tenants": TENANTS,
          "resident_cap": TENANT_CAP, "fit_seconds": fit_s,
          "trees_x_depth": per_batch, "ladder_buckets": ladder,
          "requests": len(answers) + 2 * TENANTS,
          "by_tenant": {n: served[n] for n in names},
          "evictions": evictions, "restores": restores,
          "page_in_seconds_mean": page_s / max(restores, 1),
          "latency_p50_ms": statistics.median(lats) * 1e3,
          "latency_p99_ms": sorted(lats)[int(0.99 * (len(lats) - 1))] * 1e3,
          "descend_launches": launches,
          "memory_allocated_cap_full": mem_full,
          "memory_allocated_after": mem_after,
          "bench": bench})
    return launches


def routed(np, client, Xs, direct, rng, n, max_rows):
    """``n`` sequential routed predicts of 1..``max_rows`` rows: per
    response (version, bit-identical to that version's direct predict),
    and the wall seconds of each."""
    out, lats = [], []
    for _ in range(n):
        k = int(rng.integers(1, max_rows + 1))
        lo = int(rng.integers(0, len(Xs) - k + 1))
        t0 = time.perf_counter()
        got, version = client.predict(Xs[lo:lo + k])
        lats.append(time.perf_counter() - t0)
        out.append((version, got.tobytes()
                    == direct[version][lo:lo + k].tobytes()))
    return out, lats


def predict_500s():
    """The ``/predict`` answers with status 500 so far, from the serve
    frontends' ``serve_requests_total`` (every in-process replica's)."""
    from dmlc_core_tpu_torch.base.metrics import default_registry

    return sum(se["value"] for se in default_registry().snapshot()
               ["metrics"].get("dmlc_serve_requests_total", {})
               .get("series", [])
               if se["labels"] == {"path": "/predict", "code": "500"})


def fleet_traffic(np, url, Xs, direct, seconds, action, clients=3):
    """``clients`` threads predict through the router for ``seconds``;
    ``action()`` runs a third of the way in.  Returns the responses
    ``(version, bit-identical)`` and the dropped requests."""
    import threading

    from dmlc_core_tpu_torch.base.resilience import RetryPolicy
    from dmlc_core_tpu_torch.serve import ResilientClient

    out, dropped, stop = [], [], threading.Event()
    lock = threading.Lock()
    policy = RetryPolicy(max_attempts=8, base_backoff_s=0.02,
                         deadline_s=30.0)

    def loop(seed):
        c = ResilientClient(url, policy=policy)
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            k = int(rng.integers(1, 17))
            lo = int(rng.integers(0, len(Xs) - k + 1))
            try:
                got, version = c.predict(Xs[lo:lo + k], timeout_ms=10_000)
            except Exception as e:  # noqa: BLE001 — counted, then failed
                with lock:
                    dropped.append(f"{type(e).__name__}: {e}"[:200])
                continue
            # a version the script did not publish is a wrong answer
            ok = (version in direct and got.tobytes()
                  == direct[version][lo:lo + k].tobytes())
            with lock:
                out.append((version, ok))

    threads = [threading.Thread(target=loop, args=(300 + i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    time.sleep(seconds / 3)
    result = action()
    time.sleep(2 * seconds / 3)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    return out, dropped, result


def phase_fleet(torch, np, H, smi):
    """The replica fleet on the card (see the module docstring, 12h).
    Returns the ``descend_kernel`` launches of its sequential routed
    run."""
    from dmlc_core_tpu_torch.base.resilience import RetryPolicy
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.serve import (ResilientClient, checkpoint_model,
                                           model_from_bytes, model_to_bytes)
    from dmlc_core_tpu_torch.serve.fleet import (FleetRouter, FleetTracker,
                                                 HttpFleetAdmin, Replica,
                                                 Rollout)

    X, y = higgs_like(np, FLEET_ROWS, FEATURES, 11)
    Xs = X[:512]
    depth, trees = 4, {1: 5, 2: 10}
    models = {v: HistGBT(n_trees=t, max_depth=depth, n_bins=32,
                         learning_rate=0.3, device=DEVICE).fit(X, y)
              for v, t in trees.items()}
    direct = {v: m.predict(Xs) for v, m in models.items()}
    for v, m in models.items():
        cpu = model_from_bytes(model_to_bytes(m), device="cpu")
        require(cpu.predict(Xs).tobytes() == direct[v].tobytes(),
                f"fleet: v{v} card and CPU predict differ")
    require(direct[1].tobytes() != direct[2].tobytes(),
            "fleet: the two versions predict alike")
    tmp = tempfile.mkdtemp(prefix="chip_fleet_")
    uris = {v: f"file://{tmp}/v{v}.ckpt" for v in trees}
    for v, m in models.items():
        checkpoint_model(uris[v], m, version=v)
    tracker = FleetTracker(nworker=8)
    tracker.start()
    replicas, router = [], None
    try:
        replicas = [Replica("127.0.0.1", tracker.port, model_uri=uris[1],
                            max_batch=FLEET_MAX_BATCH, heartbeat_s=0.1,
                            device=DEVICE)
                    for _ in range(FLEET_REPLICAS)]
        for r in replicas:
            model = r.registry.current()[1].model
            require(model.device.type == torch.device(DEVICE).type,
                    f"fleet: replica {r.rank} serves on {model.device}")
            r.registry.current()[1].warmup()
        router = FleetRouter(tracker, probe_s=0.1).start()
        client = ResilientClient(router.url, policy=RetryPolicy(
            max_attempts=6, base_backoff_s=0.01))
        rng = np.random.default_rng(31)
        # the router hides a replica's failed predict (a 500) by failing
        # over to the next one: every 500 of this phase fails it
        errors0 = predict_500s()
        H.descend_kernel.launches = 0
        H.descend_kernel.dir_launches = 0
        seq, lats = routed(np, client, Xs, direct, rng, FLEET_REQUESTS,
                           FLEET_MAX_BATCH)
        launches = H.descend_kernel.launches
        require(all(v == 1 and ok for v, ok in seq),
                "fleet: a routed response differs from v1's predict")
        require(launches == trees[1] * depth * len(seq)
                and H.descend_kernel.dir_launches == 0,
                f"fleet: {launches} descend launches for {len(seq)} "
                f"batches, want {trees[1] * depth} a batch")
        from dmlc_core_tpu_torch.base.metrics import default_registry
        routed_by = {se["labels"]["replica"]: se["value"] for se in
                     default_registry().snapshot()["metrics"]
                     .get("dmlc_fleet_routed_total", {}).get("series", [])}
        # (a2) one replica dies uncleanly under traffic
        victim = replicas[1]
        kill_out, dropped, _ = fleet_traffic(
            np, router.url, Xs, direct, 3.0,
            lambda: victim.close(clean=False))
        require(not dropped, f"fleet: dropped under the kill {dropped[:3]}")
        require(kill_out and all(ok for _, ok in kill_out),
                "fleet: a wrong answer under the kill")
        require(victim.rank in tracker.dead_workers,
                f"fleet: tracker missed the death ({tracker.dead_workers})")
        live = [r for r in replicas if r is not victim]
        router.probe_now()
        require(sorted(tracker.serve_endpoints()) ==
                sorted(r.rank for r in live),
                f"fleet: endpoints {tracker.serve_endpoints()}")
        # (a3) a staged rollout to v2 under traffic
        roll_out, dropped, report = fleet_traffic(
            np, router.url, Xs, direct, 3.0,
            lambda: Rollout(HttpFleetAdmin(tracker.serve_endpoints()),
                            wave_size=1, settle_s=0.2).run(uris[2]))
        require(report["outcome"] == "activated" and report["version"] == 2,
                f"fleet: rollout {report}")
        require(not dropped, f"fleet: dropped in the rollout {dropped[:3]}")
        require(all(ok for _, ok in roll_out),
                "fleet: a wrong answer in the rollout")
        require(all(r.registry.current_version() == 2 for r in live),
                "fleet: the rollout did not converge on v2")
        after, _ = routed(np, client, Xs, direct, rng, 10, FLEET_MAX_BATCH)
        require(all(v == 2 and ok for v, ok in after),
                "fleet: after the rollout a response is not v2's")
        errors = predict_500s() - errors0
        require(errors == 0, f"fleet: {errors} predicts failed in a replica")
    finally:
        if router is not None:
            router.close()
        for r in replicas:
            try:
                r.close()
            except Exception:  # noqa: BLE001 — the killed one is closed
                pass
        tracker.stop()
    del models
    gc_cuda(torch)
    bench = bench_child("--fleet", "fleet_requests_per_sec", FLEET_TIMEOUT)
    # the child's JobSet respawns a crashed replica and its router fails
    # over a replica's failed predict: both would hide a fault, so a
    # respawn or a transport failover fails the phase, as does a replica
    # or a routed answer not on v2 once the rollout is done
    post = bench["post_rollout"]
    require(bench["ok"] > 0 and bench["dropped"] == 0
            and bench["wrong"] == 0
            and bench["launch"]["respawns"] == 0
            and bench["failover"].get("transport", 0) == 0
            and set(bench["by_version"]) <= {"1", "2"}
            and bench["rollout"]["outcome"] == "activated"
            and bench["rollout"]["version"] == 2
            and list(bench["replica_versions"].values())
            == [2] * FLEET_REPLICAS
            and post["wrong"] == 0 and post["requests"] > 0
            and post["by_version"] == {"2": post["requests"]},
            f"bench --fleet: {json.dumps(bench)[:800]}")
    emit({"phase": "fleet", "card": smi, "replicas": FLEET_REPLICAS,
          "trees": trees, "max_depth": depth,
          "routed_requests": len(seq),
          "routed_latency_p50_ms": statistics.median(lats) * 1e3,
          "routed_latency_p99_ms":
              sorted(lats)[int(0.99 * (len(lats) - 1))] * 1e3,
          "routed_by_replica": routed_by,
          "descend_launches": launches,
          "descend_launches_per_batch": launches / len(seq),
          "kill_responses": len(kill_out), "kill_dropped": 0,
          "rollout": report,
          "rollout_versions": sorted({v for v, _ in roll_out}),
          "rollout_responses": len(roll_out),
          "bench": bench})
    return launches


# ---------------------------------------------------------------------------
# streaming, the parameter server and elastic recovery
# ---------------------------------------------------------------------------

def write_events(np, path, X, y, mode="ab"):
    """Rows ``X, y`` appended to ``path`` as dense events (one RecordIO
    record a row, the stream's codec)."""
    from dmlc_core_tpu_torch.io.recordio import encode_records
    from dmlc_core_tpu_torch.stream import encode_dense_events

    with open(path, mode) as f:
        f.write(encode_records(encode_dense_events(X, y)))


def stream_trainer(path, device, publisher=None, chunk_rows=STREAM_CHUNK,
                   window=STREAM_WINDOW, decay=1.0, name="smoke"):
    """An ``OnlineTrainer`` at the stream bench's defaults (5 trees a
    refresh, depth 4, 32 bins) over the shard at ``path``."""
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.stream import OnlineTrainer, RecordIOTailer

    model = HistGBT(device=device, **STREAM_KW)
    return OnlineTrainer(model, RecordIOTailer(path, name=name),
                         n_features=FEATURES, chunk_rows=chunk_rows,
                         window_chunks=window, decay=decay,
                         publisher=publisher, commit_cursor=False,
                         name=name)


def stream_kernels(torch, H, model, X):
    """``hist`` (root), ``fused_round`` (each level below it) and
    ``descend_kernel`` (every level of every tree) at a refresh's own
    shapes — the window's bins ``[28, 524288]`` in 32 bins — against
    their plain versions on the same inputs, bit for bit."""
    dev = torch.device(DEVICE)
    bins = model._bins_of(torch.from_numpy(X).to(dev))
    n = bins.shape[1]
    B = STREAM_KW["n_bins"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    p = torch.sigmoid(0.5 * torch.randn(n, device=dev, generator=gen))
    y = (torch.rand(n, device=dev, generator=gen) < p).float()
    g, h = p - y, p * (1 - p)
    kg, kh = H.hist_scales(g, h)
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    a = H.hist_kernel(bins, node, g, h, 1, B, kg, kh)
    c = H.hist_plain(bins, node, g, h, 1, B, kg, kh)
    torch.cuda.synchronize()
    require(torch.equal(a, c), "stream: hist kernel != hist_plain")
    errs = {"hist": max_abs_err(torch, a, c), "fused_round": 0.0,
            "descend": 0.0}
    for lv in range(1, STREAM_KW["max_depth"]):
        n_prev = 1 << (lv - 1)
        nd = torch.randint(0, n_prev, (n,), dtype=torch.int32, device=dev,
                           generator=gen)
        feat = torch.randint(0, FEATURES, (n_prev,), dtype=torch.int32,
                             device=dev, generator=gen)
        thr = torch.randint(0, B - 1, (n_prev,), dtype=torch.int32,
                            device=dev, generator=gen)
        prev = H.hist_plain(bins, nd, g, h, n_prev, B, kg, kh)
        a = H.fused_round_kernel(bins, nd, feat, thr, g, h, prev, n_prev, B,
                                 kg, kh, True)
        c = H.fused_round_plain(bins, nd, feat, thr, g, h, prev, n_prev, B,
                                kg, kh, True)
        torch.cuda.synchronize()
        require(torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]),
                f"stream: fused_round != plain (n_prev {n_prev})")
        errs["fused_round"] = max(errs["fused_round"],
                                  max_abs_err(torch, a[1], c[1]))
    st = model._stacked_trees(model.trees)
    for t in range(st["feat"].shape[0]):
        node = torch.zeros(n, dtype=torch.int32, device=dev)
        for lv in range(STREAM_KW["max_depth"]):
            feat = st["feat"][t, lv].to(torch.int32).contiguous()
            thr = st["thr"][t, lv].to(torch.int32).contiguous()
            a = H.descend_kernel(bins, node, feat, thr, True)
            c = H.descend_plain(bins, node, feat, thr, True)
            require(torch.equal(a, c),
                    f"stream: descend_kernel != plain (tree {t}, level {lv})")
            node = a
    return errs


def phase_stream(torch, np, H, smi):
    """Online learning on the card (see the module docstring, 12i).
    Returns the kernel launches of its main run and the largest errors of
    the kernels held at the big refresh's shapes."""
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.serve import ModelRegistry
    from dmlc_core_tpu_torch.stream import ModelPublisher

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_stream_")
    X, y = higgs_like(np, STREAM_EVENTS, FEATURES, 21)
    Xh, yh = higgs_like(np, 4096, FEATURES, 22)
    shard = os.path.join(tmp, "events.rec")
    write_events(np, shard, X, y, "wb")
    # (a) the main run: 6 refreshes gated by a publisher, launch counts
    # set to 0 just before and read just after
    reg = ModelRegistry(max_batch=256, min_bucket=8, device=DEVICE)
    pub = ModelPublisher(reg, holdout=(Xh, yh), name="smoke")
    tr = stream_trainer(shard, DEVICE, publisher=pub)
    zero_counts(H)
    outs = tr.run(max_refreshes=STREAM_REFRESHES, timeout=1.0)
    launches = {"hist": H.hist_kernel.launches,
                "fused_round": H.fused_round_kernel.launches,
                "descend": H.descend_kernel.launches}
    require(len(outs) == STREAM_REFRESHES
            and [o["window_rows"] for o in outs[:2]]
            == [STREAM_CHUNK, STREAM_CHUNK * STREAM_WINDOW],
            f"stream: refreshes {[(o['rows'], o['window_rows']) for o in outs]}")
    trees = STREAM_KW["n_trees"] * STREAM_REFRESHES
    require(launches["hist"] == trees and launches["fused_round"]
            == trees * (STREAM_KW["max_depth"] - 1),
            f"stream: launches {launches} for {trees} trees")
    require(launches["descend"] > 0, "stream: no descend launch (the "
            "margin replay and the gate run on the card)")
    require(pub.activations >= 1, "stream: nothing activated")
    # the card's model file after 3 refreshes equals the CPU's
    files = {}
    for dev in (DEVICE, "cpu"):
        t3 = stream_trainer(shard, dev, name=f"files-{dev}")
        t3.run(max_refreshes=3, timeout=1.0)
        files[dev] = model_bytes_of(t3.model)
    require(files[DEVICE] == files["cpu"],
            "stream: the card's file after 3 refreshes != the CPU's")
    # the warm-start contract on the card: window 1, decay 1 over chunks
    # A then B writes the file of fit(A); fit(B)
    A = slice(0, STREAM_CHUNK)
    Bs = slice(STREAM_CHUNK, 2 * STREAM_CHUNK)
    manual = HistGBT(device=DEVICE, **STREAM_KW)
    manual.fit(X[A], y[A])
    manual.fit(X[Bs], y[Bs])
    tw = stream_trainer(shard, DEVICE, window=1, name="warm")
    tw.run(max_refreshes=2, timeout=1.0)
    require(model_bytes_of(tw.model) == model_bytes_of(manual),
            "stream: warm-start contract broken on the card")
    # a forced regression: poisoned (flipped) labels, rolled back with
    # traffic still on the good version
    good_v, runner = reg.current()
    good = np.asarray(runner.predict(Xh[:256]))
    Xp, yp = higgs_like(np, 2 * STREAM_CHUNK, FEATURES, 23)
    write_events(np, shard, Xp, 1.0 - yp)
    rolled = [tr.refresh(timeout=1.0) for _ in range(2)]
    require(any(r is not None and not r["activated"] for r in rolled),
            f"stream: the poisoned refreshes activated ({rolled})")
    cur_v, runner = reg.current()
    require(pub.rollbacks >= 1 and cur_v in reg.versions(),
            "stream: no rollback counted")
    if all(not r["activated"] for r in rolled):
        require(cur_v == good_v and np.asarray(runner.predict(
            Xh[:256])).tobytes() == good.tobytes(),
                "stream: traffic left the good version")
    emit({"phase": "stream", "part": "main", "refreshes": len(outs),
          "refresh_seconds": [o["refresh_seconds"] for o in outs],
          "fit_seconds": [o["fit_seconds"] for o in outs],
          "launches": launches, "activations": pub.activations,
          "rollbacks": pub.rollbacks,
          "poisoned": [None if r is None else
                       {k: r[k] for k in ("version", "activated", "score",
                                          "baseline")} for r in rolled],
          "files_equal_cpu": True, "warm_start_contract": True})
    del X, y
    # (b) one refresh at chunk_rows 262,144 (window 2: 524,288 rows),
    # timed by part: tail (poll), decode, fit, publish
    Xb, yb = higgs_like(np, 2 * STREAM_BIG, FEATURES, 24)
    big = os.path.join(tmp, "big.rec")
    write_events(np, big, Xb, yb, "wb")
    reg2 = ModelRegistry(max_batch=256, min_bucket=8, device=DEVICE)
    pub2 = ModelPublisher(reg2, holdout=(Xh, yh), name="big")
    tb = stream_trainer(big, DEVICE, publisher=pub2, chunk_rows=STREAM_BIG,
                        name="big")
    parts = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            return out
        return run

    tb.tailer.wait_records = timed("tail", tb.tailer.wait_records)
    tb._decode = timed("decode", tb._decode)
    pub2.publish = timed("publish", pub2.publish)
    tb.refresh(timeout=30.0)                  # the window's first chunk
    zero_counts(H)
    r = tb.refresh(timeout=30.0)
    big_launches = {"hist": H.hist_kernel.launches,
                    "fused_round": H.fused_round_kernel.launches,
                    "descend": H.descend_kernel.launches}
    require(r is not None and r["window_rows"] == 2 * STREAM_BIG,
            f"stream: big refresh {r}")
    for k, v in big_launches.items():
        launches[k] += v
    errs = stream_kernels(torch, H, tb.model, Xb)
    emit({"phase": "stream", "part": "big_refresh", "chunk_rows": STREAM_BIG,
          "window_rows": r["window_rows"], "features": FEATURES,
          "tail_seconds": parts["tail"], "decode_seconds": parts["decode"],
          "fit_seconds": r["fit_seconds"],
          "publish_seconds": parts["publish"],
          "refresh_seconds": r["refresh_seconds"],
          "activated": r.get("activated"), "launches": big_launches,
          "kernels_held": errs, "nvidia_smi": smi})
    del Xb, yb
    shutil.rmtree(tmp, ignore_errors=True)
    # (c) the port bench's --stream as a child process at its defaults
    rec = bench_child("--stream", "stream_staleness_seconds", STREAM_TIMEOUT)
    st = rec["staleness_seconds"]
    require(all(isinstance(st[q], float) for q in ("p50", "p95", "p99"))
            and rec["refreshes_published"] >= 1 and rec["events_served"] > 0,
            f"bench --stream: {json.dumps(rec)[:500]}")
    emit({**rec, "phase": "stream", "part": "bench",
          "phase_seconds": time.perf_counter() - t_phase})
    return launches, errs


def ctr_blocks(np, n, F, nnz, seed):
    """Sparse CTR rows (the PS bench's rule at a smaller width): ``nnz``
    hashed ids a row, the label from a few signal features."""
    from dmlc_core_tpu_torch.data.row_block import RowBlock

    rng = np.random.default_rng(seed)
    hot = rng.choice(F, 64, replace=False)
    w_true = rng.normal(size=64).astype(np.float32)
    idx = rng.integers(0, F, size=(n, nnz)).astype(np.int64)
    pick = rng.integers(0, 64, size=(n, 4))
    idx[:, :4] = hot[pick]
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    y = ((vals[:, :4] * w_true[pick]).sum(1) > 0).astype(np.float32)
    off = np.arange(0, n * nnz + 1, nnz, dtype=np.int64)
    return [RowBlock(offset=off, label=y, index=idx.ravel(),
                     value=vals.ravel())]


def phase_ps(torch, np, smi):
    """The parameter server with models on the card (see the module
    docstring, 12j)."""
    import threading

    from dmlc_core_tpu_torch.models import FM, GBLinear
    from dmlc_core_tpu_torch.parallel.kvstore import (DistAsyncKVStore,
                                                      KVStore)
    from dmlc_core_tpu_torch.parallel.ps import (PSClient, PSScheduler,
                                                 PSServer)

    t_phase = time.perf_counter()
    F = PS_FEATURES
    sched = PSScheduler("127.0.0.1", nworker=2, nserver=2)
    sched.start()
    servers = [PSServer("127.0.0.1", sched.port, server_id=i)
               for i in range(2)]
    threads = []
    for srv in servers:
        srv.start()
        threads.append(threading.Thread(target=srv.serve_forever,
                                        daemon=True))
        threads[-1].start()
    models, errors = {}, []

    def worker(rank):
        try:
            kv = DistAsyncKVStore(PSClient(root_uri="127.0.0.1",
                                           root_port=sched.port, rank=rank),
                                  learning_rate=0.3)
            blocks = ctr_blocks(np, PS_ROWS, F, 16, 30 + rank)
            lin = GBLinear(device=DEVICE, learning_rate=0.3, reg_lambda=0.0)
            lin.fit_ps(blocks, kv, num_col=F, batch_rows=1024, n_epochs=2)
            fm = FM(device=DEVICE, n_factors=8, n_epochs=2, seed=3)
            fm.fit_ps(blocks, kv, num_col=F, batch_rows=1024)
            models[rank] = (lin, fm, blocks, max(kv.staleness_samples))
            kv.close()
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))

    wts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    t0 = time.perf_counter()
    for t in wts:
        t.start()
    for t in wts:
        t.join(timeout=PS_TIMEOUT)
    fit_s = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=30)
    sched.join(timeout=30)
    require(not errors and sorted(models) == [0, 1], f"ps: {errors}")
    lin, fm, blocks, lag = models[0]
    require(lag <= 4, f"ps: staleness {lag} past the bound")
    Xd = blocks[0].to_dense(F)[:PS_PREDICT_ROWS]
    yd = blocks[0].label[:PS_PREDICT_ROWS]
    # finalized predict on the card vs the CPU's on the same weights
    lin_cpu = GBLinear(device="cpu")
    lin_cpu.weights, lin_cpu.bias = lin.weights, lin.bias
    fm_cpu = FM(device="cpu", n_factors=8)
    fm_cpu.params_from_numpy({k: v.cpu().numpy()
                              for k, v in fm.params.items()})
    require(all(v.device.type == torch.device(DEVICE).type
                for v in fm.params.values()),
            "ps: FM's finalized parameters are not on the card")
    errs = {}
    for name, m, c in (("gblinear", lin, lin_cpu), ("fm", fm, fm_cpu)):
        a = m.predict(Xd, output_margin=True)
        b = c.predict(Xd, output_margin=True)
        errs[name] = float(np.max(np.abs(a - b)))
        np.testing.assert_allclose(a, b, rtol=PS_RTOL, atol=PS_ATOL)
    acc = float(((lin.predict(Xd) > 0.5) == (yd > 0.5)).mean())
    require(acc > 0.7, f"ps: GBLinear accuracy {acc}")
    # KVStore("local") on the card: the CPU's bytes
    out = {}
    rng = np.random.default_rng(5)
    vals = [rng.normal(size=s).astype(np.float32)
            for s in ((4000, 128), (128, 512), (512,))]
    grads = [[rng.normal(size=v.shape).astype(np.float32) for v in vals]
             for _ in range(3)]
    keys = ["embed", "w", "b"]
    for dev in (DEVICE, "cpu"):
        kv = KVStore.create("local", learning_rate=0.01, device=dev)
        kv.init(keys, vals)
        for step in grads:
            kv.push(keys, step)
            kv.push(keys[:1], step[:1])
            kv.pull(keys)
        out[dev] = [v.cpu().numpy().tobytes() for v in kv.pull(keys)]
    require(out[DEVICE] == out["cpu"], "ps: KVStore(local) card != CPU")
    emit({"phase": "ps", "part": "fit_ps", "features": F,
          "rows_per_worker": PS_ROWS, "fit_seconds": fit_s,
          "predict_max_abs_err": errs, "gblinear_accuracy": acc,
          "staleness_max": lag, "kvstore_local_equal_cpu": True})
    rec = ps_bench_child()
    emit({**rec, "phase": "ps", "part": "bench",
          "phase_seconds": time.perf_counter() - t_phase})


def ps_bench_child():
    """``python -m dmlc_core_tpu_torch.bench --ps`` at its defaults as a
    child process: a final record with ``keys_per_sec`` and the observed
    staleness within its bound."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "PS_"))}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          "--ps"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=PS_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    require(res.returncode == 0 and lines,
            f"bench --ps exited {res.returncode}: {res.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    require(rec.get("bench") == "ps_sparse_ctr"
            and isinstance(rec.get("keys_per_sec"), float)
            and rec["keys_per_sec"] > 0
            and rec["staleness_max"] is not None
            and rec["staleness_max"] <= rec["staleness_bound"],
            f"bench --ps: bad record {lines[-1][:500]}")
    rec.pop("metrics_summary", None)
    rec["child_wall_seconds"] = wall
    return rec


def elastic_worker(tracker, directory, X, y, out, errs, rank=-1,
                   die_after_faults=None):
    """One elastic worker thread on the card (the JAX package's protocol
    tests' worker): its own ``ElasticSession`` as its thread's host
    transport, ``ElasticTrainer.run`` over ``fit_external`` legs of its
    rows; ``die_after_faults`` ends it uncleanly (its socket closed
    without a shutdown) after that many fault points."""
    import threading

    from dmlc_core_tpu_torch.data.iter import ArrayRowIter
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.parallel.recovery import (ElasticSession,
                                                       ElasticTrainer,
                                                       WorkerAborted)

    def worker():
        sess = None
        try:
            sess = ElasticSession("127.0.0.1", tracker.port, rank=rank)
            m = HistGBT(device=DEVICE, **ELASTIC_KW)
            tr = ElasticTrainer(m, ELASTIC_KW["n_trees"],
                                recovery_dir=directory, stride=2)
            if die_after_faults is not None:
                calls = [0]

                def fault():
                    calls[0] += 1
                    if calls[0] > die_after_faults:
                        raise WorkerAborted("simulated death")
                tr._worker_fault = fault
            tr.run(sess, lambda lo, hi: ArrayRowIter(X[lo:hi], y[lo:hi]),
                   len(y), join_timeout_s=120)
            out[sess.grank] = (model_bytes_of(m), tr.rounds_replayed)
            sess.shutdown()
        except WorkerAborted:
            sess.close()                # no shutdown: a death
        except Exception as e:  # noqa: BLE001 — raised by the caller
            errs.append(repr(e))
    return threading.Thread(target=worker, daemon=True)


def phase_recovery(torch, np, H, smi, X, y, lossguide_bytes):
    """Round-versioned recovery on the card (see the module docstring,
    12k)."""
    from dmlc_core_tpu_torch.base import faultinject as fi
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.parallel.recovery import (ElasticTracker,
                                                       ElasticTrainer,
                                                       WorkerAborted)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_recovery_")
    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    # (a) run_device on configuration 1's handle, stride 2, killed after
    # the round-2 commit (the third fault point: rounds 1 and 2, then the
    # commit), resumed by a fresh model
    with levers(BENCH_LEVERS):
        m1 = HistGBT(device=DEVICE, **kw)
        dd = m1.make_device_data(X, y)
        require(dd["layout"] is None, "recovery: a layout fired")
        tr1 = ElasticTrainer(m1, TREES, recovery_dir=tmp, stride=2)
        with fi.inject("worker:abort:after=2"):
            try:
                tr1.run_device(dd)
                require(False, "recovery: the injected abort never fired")
            except WorkerAborted:
                pass
        require(tr1.rounds_trained == 2, f"recovery: killed at round "
                f"{tr1.rounds_trained}")
        del dd, m1
        m2 = HistGBT(device=DEVICE, **kw)
        dd = m2.make_device_data(X, y)
        tr2 = ElasticTrainer(m2, TREES, recovery_dir=tmp, stride=2)
        zero_counts(H)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr2.run_device(dd)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        counts = read_counts(H)
        replay = H.descend_kernel.launches
    require(tr2.resumed_from == 2, f"recovery: resumed from "
            f"{tr2.resumed_from}")
    require(model_bytes_of(m2) == lossguide_bytes,
            "recovery: the resumed run's file != phase main_lossguide's")
    del dd, m2
    gc_cuda(torch)
    emit({"phase": "recovery", "part": "run_device", "stride": 2,
          "killed_at_round": 2, "resumed_from": 2,
          "resume_seconds": resume_s, "launches": counts,
          "replay_descend_launches": replay, "file_equal_main": True})
    # (b) run over fit_external: 2 worker threads on the card under an
    # ElasticTracker, clean and with a kill and rejoin
    Xs, ys = X[:ELASTIC_ROWS], y[:ELASTIC_ROWS]
    blobs = {}
    for mode in ("clean", "kill"):
        d = os.path.join(tmp, mode)
        tracker = ElasticTracker(nworker=2, grace_s=60.0)
        tracker.start()
        out, errs = {}, []
        t0 = time.perf_counter()
        try:
            threads = [elastic_worker(
                tracker, d, Xs, ys, out, errs,
                die_after_faults=1 if mode == "kill" and i == 1 else None)
                for i in range(2)]
            for t in threads:
                t.start()
            if mode == "kill":
                deadline = time.time() + 120
                while time.time() < deadline and not tracker.lost_ranks():
                    time.sleep(0.05)
                lost = tracker.lost_ranks()
                require(len(lost) == 1, f"recovery: lost {lost}")
                threads.append(elastic_worker(tracker, d, Xs, ys, out, errs,
                                              rank=lost[0]))
                threads[-1].start()
            for t in threads:
                t.join(timeout=ELASTIC_TIMEOUT)
            floor = tracker.recovery_floor()
        finally:
            tracker.stop()
        require(not errs and sorted(out) == [0, 1],
                f"recovery {mode}: {errs} {sorted(out)}")
        files = [v[0] for v in out.values()]
        require(files[0] == files[1], f"recovery {mode}: workers disagree")
        blobs[mode] = files[0]
        emit({"phase": "recovery", "part": f"elastic_{mode}",
              "rows": ELASTIC_ROWS, "workers": 2, "floor": floor,
              "rounds_replayed": {r: v[1] for r, v in out.items()},
              "seconds": time.perf_counter() - t0})
    require(blobs["kill"] == blobs["clean"],
            "recovery: the kill-and-rejoin run's file != the clean run's")
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "recovery", "part": "done", "kill_equals_clean": True,
          "phase_seconds": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# ResNet over RecordIO image records, and the production-day drill
# ---------------------------------------------------------------------------

def resnet_steps(torch, np, device, dtype, arch, params, stats, batches):
    """Trainer steps of the ``arch`` model (stage sizes, bottleneck,
    filters) on ``device`` from the carried weights: the losses, and the
    weights and BN running statistics after them."""
    from dmlc_core_tpu_torch.models.resnet import ResNet, ResNetTrainer

    tr = ResNetTrainer(device=device, dtype=dtype, variant="resnet-micro",
                       num_classes=RESNET_MICRO_CLASSES, learning_rate=0.05)
    stages, bottleneck, filters = arch
    tr.model = ResNet(stages, bottleneck, RESNET_MICRO_CLASSES, filters,
                      dtype).to(tr.device)
    tr.params_from_numpy(params, stats)
    losses = []
    for x, y in batches:
        loss, _acc = tr.train_step(torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(loss))
    return (np.array(losses), *tr.numpy_params())


class _ReluMasks:
    """Stands in for ``torch.nn.functional`` inside ``models.resnet``:
    records each ``relu``'s input sign, in call order."""

    def __init__(self, F):
        self._F = F
        self.masks = []

    def __getattr__(self, name):
        return getattr(self._F, name)

    def relu(self, x, *a, **kw):
        self.masks.append((x.detach() > 0).cpu())
        return self._F.relu(x, *a, **kw)


def relu_step(torch, np, device, hw, batch, cudnn=True, nudge=0.0):
    """One f32 ResNet-50 forward and backward of the training loss on
    ``device`` (weights of ``RESNET_SEED``, each scaled by ``1 +
    nudge·N(0, 1)``): the parameter gradients and the ReLU input signs."""
    import torch.nn.functional as F

    from dmlc_core_tpu_torch.models import resnet

    model = resnet.ResNet((3, 4, 6, 3), True, RESNET_MICRO_CLASSES, 64,
                          torch.float32, generator=torch.Generator()
                          .manual_seed(RESNET_SEED))
    if nudge:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + nudge * torch.randn(p.shape, generator=g))
    model.to(device)
    rng = np.random.default_rng(RESNET_SEED)
    x = torch.from_numpy(rng.integers(0, 256, size=(batch, hw, hw, 3),
                                      dtype=np.uint8)).to(device)
    y = torch.from_numpy(rng.integers(0, RESNET_MICRO_CLASSES, size=batch)
                         ).long().to(device)
    rec = _ReluMasks(F)
    resnet.F = rec
    try:
        with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            F.cross_entropy(model(x, train=True), y).backward()
    finally:
        resnet.F = F
    return ([p.grad.detach().double().cpu() for p in model.parameters()],
            rec.masks)


def relu_sensitivity(torch, np, hw, batch):
    """Why ResNet-50's update parts card from CPU (ROADMAP C18): one
    step's gradients on the card with cuDNN and without, and on the CPU
    under a ``RESNET_NUDGE`` relative nudge of the weights, each against
    the CPU's (global norm of the difference over the CPU's), with the
    ReLU inputs that land on the other side of 0."""
    def rel(got, want):
        num = sum(float((a - b).norm() ** 2) for a, b in zip(got, want))
        return (num / sum(float(b.norm() ** 2) for b in want)) ** 0.5

    def flips(got, want):
        return sum(int((a != b).sum()) for a, b in zip(got, want))

    cg, cm = relu_step(torch, np, "cpu", hw, batch)
    out = {"relu_inputs": sum(int(m.numel()) for m in cm)}
    for name, device, cudnn, nudge in (
            ("cudnn", DEVICE, True, 0.0), ("native", DEVICE, False, 0.0),
            ("cpu_nudged", "cpu", True, RESNET_NUDGE)):
        g, m = relu_step(torch, np, device, hw, batch, cudnn, nudge)
        out[name] = {"grad_rel": rel(g, cg), "relu_flips": flips(m, cm)}
    return out


def leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaves(v) if isinstance(v, dict) else [v]
    return out


def resnet_cross_device(torch, np, smi):
    """(a) of ``resnet``: each ``RESNET_CROSS`` model's trainer steps on
    the card against the same steps on the CPU from the same carried
    weights — f32 with TF32 off for cuDNN (scoped:
    ``torch.backends.cudnn.flags``), then bf16 where the case has it."""
    from dmlc_core_tpu_torch.models.resnet import ResNet, ResNetTrainer

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def rel_change(got, want, start):
        num = sum(float(np.sum((a - b) ** 2)) for a, b in
                  zip(leaves(got), leaves(want)))
        den = sum(float(np.sum((b - c) ** 2)) for b, c in
                  zip(leaves(want), leaves(start)))
        return (num / den) ** 0.5

    cross = {}
    for (model, stages, bottleneck, filters, hw, batch, steps,
         tols) in RESNET_CROSS:
        rng = np.random.default_rng(RESNET_SEED)
        batches = [(rng.integers(0, 256, size=(batch, hw, hw, 3),
                                 dtype=np.uint8),
                    rng.integers(0, RESNET_MICRO_CLASSES,
                                 size=batch).astype(np.int32))
                   for _ in range(steps)]
        arch = (stages, bottleneck, filters)
        ref = ResNetTrainer(device="cpu", dtype=torch.float32,
                            variant="resnet-micro",
                            num_classes=RESNET_MICRO_CLASSES)
        ref.model = ResNet(stages, bottleneck, RESNET_MICRO_CLASSES,
                           filters, torch.float32,
                           generator=torch.Generator().manual_seed(
                               RESNET_SEED))
        params, stats = ref.numpy_params()
        case = {"shape": [batch, hw, hw, 3], "steps": steps}
        for name, (loss_rtol, stats_tol, upd_tol) in tols.items():
            t0 = time.perf_counter()
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                got_l, got_p, got_s = resnet_steps(
                    torch, np, DEVICE, dtypes[name], arch, params, stats,
                    batches)
            want_l, want_p, want_s = resnet_steps(
                torch, np, "cpu", dtypes[name], arch, params, stats,
                batches)
            upd = rel_change(got_p, want_p, params)
            st = rel_change(got_s, want_s, stats)
            loss_err = float(np.max(np.abs(got_l - want_l)
                                    / np.abs(want_l)))
            require(np.all(np.isfinite(got_l)) and loss_err <= loss_rtol
                    and st <= stats_tol and upd <= upd_tol,
                    f"resnet {model} {name}: card vs CPU losses {got_l} / "
                    f"{want_l} (rel {loss_err:.3g} > {loss_rtol}?), "
                    f"statistics rel {st:.3g} (> {stats_tol}?), update "
                    f"rel {upd:.3g} (> {upd_tol}?)")
            case[name] = {"loss_rel_err": loss_err, "loss_rtol": loss_rtol,
                          "stats_rel_err": st, "stats_tol": stats_tol,
                          "update_rel_err": upd, "update_tol": upd_tol,
                          "losses": got_l.tolist(),
                          "seconds": time.perf_counter() - t0}
        if model == "resnet50":
            case["relu_sensitivity"] = relu_sensitivity(torch, np, hw,
                                                         batch)
        cross[model] = case
    require(torch.backends.cudnn.allow_tf32,
            "resnet: the TF32 setting leaked out of its scope")
    emit({"phase": "resnet", "part": "cross_device", **cross,
          "nvidia_smi": smi})



def _libsvm_text(rows) -> bytes:
    """``%.9g`` libsvm text of ``[label, features...]`` rows (float64 of
    the f32 values), every feature written."""
    tmpl = ("%.9g " + " ".join(f"{j}:%.9g" for j in range(rows.shape[1] - 1))
            + "\n")
    return "".join(tmpl % tuple(r) for r in rows.tolist()).encode()


def libsvm_shard_texts(np, X, y, shards):
    """The rows as ``shards`` consecutive pieces of libsvm text (bytes),
    one process a piece."""
    import multiprocessing

    parts = [np.concatenate([y[p, None], X[p]], axis=1).astype(np.float64)
             for p in np.array_split(np.arange(len(y)), shards)]
    with multiprocessing.get_context("spawn").Pool(shards) as pool:
        return pool.map(_libsvm_text, parts)


def s3_fake(store):
    """A ``ThreadingHTTPServer`` on 127.0.0.1 answering the S3 requests
    the port's ``s3://`` backend makes of a path-style endpoint (HEAD, a
    ranged GET, ListObjectsV2) from ``store`` (``"bucket/key"`` → bytes).
    Returns ``(server, endpoint)``; the caller shuts it down."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, status, body=b"", length=None):
            self.send_response(status)
            self.send_header("Content-Length",
                             str(len(body) if length is None else length))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_HEAD(self):
            key = urllib.parse.unquote(self.path.lstrip("/").split("?")[0])
            if key in store:
                self._send(200, length=len(store[key]))
            else:
                self._send(404)

        def do_GET(self):
            parsed = urllib.parse.urlsplit(self.path)
            q = dict(urllib.parse.parse_qsl(parsed.query,
                                            keep_blank_values=True))
            key = urllib.parse.unquote(parsed.path.lstrip("/"))
            if "list-type" in q:
                bucket = key.split("/")[0]
                prefix = f"{bucket}/{q.get('prefix', '')}"
                items = "".join(
                    f"<Contents><Key>{k[len(bucket) + 1:]}</Key>"
                    f"<Size>{len(v)}</Size></Contents>"
                    for k, v in sorted(store.items()) if k.startswith(prefix))
                self._send(200, (f"<ListBucketResult>{items}"
                                 "</ListBucketResult>").encode())
                return
            if key not in store:
                self._send(404)
                return
            blob = store[key]
            rng = self.headers.get("Range")
            if not rng:
                self._send(200, blob)
                return
            lo, _, hi = rng.split("=")[1].partition("-")
            lo, hi = int(lo), (int(hi) if hi else len(blob) - 1)
            self._send(206, blob[lo:hi + 1])

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def run_submits(jobs, env, log_dir):
    """Every ``{name: (job, world)}`` at once: ``python -m
    dmlc_core_tpu_torch.tracker.submit --cluster local`` with ``world``
    workers running ``parallel.launch --worker job.json``, each its own
    process group, under one time limit.  Returns each one's wall
    seconds; a failure or the time limit raises after every group is
    stopped."""
    runs = {}
    try:
        for name, (job, world) in jobs.items():
            job_path = os.path.join(log_dir, f"job_{name}.json")
            with open(job_path, "w") as f:
                json.dump(job, f)
            log = open(os.path.join(log_dir, f"submit_{name}.log"), "w+")
            runs[name] = [None, log, time.perf_counter(), None]
            runs[name][0] = subprocess.Popen(
                [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
                 "--cluster", "local", "--num-workers", str(world),
                 "--max-attempts", "1", "--log-level", "WARNING", "--",
                 sys.executable, "-m", "dmlc_core_tpu_torch.parallel.launch",
                 "--worker", job_path],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        deadline = time.perf_counter() + SUBMIT_TIMEOUT
        while (any(r[3] is None for r in runs.values())
               and time.perf_counter() < deadline):
            for r in runs.values():
                if r[3] is None and r[0].poll() is not None:
                    r[3] = time.perf_counter()
            time.sleep(0.05)
    finally:
        for proc, log, _, _ in runs.values():
            if proc is not None and proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()
    for name, (proc, log, t0, t1) in runs.items():
        with open(log.name) as f:
            text = f.read()
        require(t1 is not None and proc.returncode == 0,
                f"submit {name} exited {proc.returncode} (killed at "
                f"{SUBMIT_TIMEOUT} s if it had not ended): {text[-6000:]}")
    return {name: r[3] - r[2] for name, r in runs.items()}


def phase_submit(torch, np, H, smi):
    """dmlc-submit's local cluster, workers that read from an object
    store, the native parse and the data-parallel ``HistGBT`` on the card.
    The first 1M of configuration 1's rows as ``%.9g`` libsvm text in 4
    shards, served by :func:`s3_fake` through ``S3_ENDPOINT`` and kept on
    local disk; (iii) the in-core ``fit`` on the card on the rows the
    native parser reads back from the local shards (its cuts are every
    run's); (i) ``--num-workers 2`` from ``s3://``, gloo ranks sharing the
    card, each parsing its ``InputSplit`` part and fitting by
    ``fit_external`` (the chunked route); (ii) ``--num-workers 1`` from
    the local shards, a NCCL group of one (the native chunk reader, the
    cached route), started together with (i).  Held: (i)'s and (ii)'s files byte-identical to
    (iii)'s, every rank's native parse calls (and (ii)'s native chunk
    reads) above 0; printed: the parse's values that differ from the
    generator's f32 rows.  Returns the phase's launches of ``hist``,
    ``fused_round`` and ``descend``."""
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.data import _native
    from dmlc_core_tpu_torch.data.iter import RowBlockIter
    from dmlc_core_tpu_torch.io import _native_io

    t_phase = time.perf_counter()
    X, y = higgs_like(np, SUBMIT_ROWS, FEATURES, 7)
    t0 = time.perf_counter()
    texts = libsvm_shard_texts(np, X, y, SUBMIT_SHARDS)
    text_s = time.perf_counter() - t0
    d = tempfile.mkdtemp(prefix="chip_submit_")
    srv = None
    try:
        local = os.path.join(d, "shards")
        os.mkdir(local)
        for k, blob in enumerate(texts):
            with open(os.path.join(local, f"part-{k}.libsvm"), "wb") as f:
                f.write(blob)
        store = {f"bkt/higgs/part-{k}.libsvm": blob
                 for k, blob in enumerate(texts)}
        text_bytes = sum(len(b) for b in texts)
        del texts
        srv, endpoint = s3_fake(store)

        # the native parse of the local shards, against the generator's
        _native.reset_calls()
        _native_io.reset_calls()
        t0 = time.perf_counter()
        it = RowBlockIter.create(local, 0, 1, "libsvm")
        block = it.value
        Xp = block.to_dense(FEATURES)
        yp = np.asarray(block.label, np.float32)
        it.close()
        parse_s = time.perf_counter() - t0
        parse_calls = {**_native.calls(), **_native_io.calls()}
        require(parse_calls["parse_libsvm"] > 0
                and parse_calls["prefetch_chunks"] > 0,
                f"submit: the local parse did not run natively "
                f"({parse_calls})")
        require(Xp.shape == X.shape and yp.shape == y.shape,
                f"submit: parsed {Xp.shape}, {yp.shape}")
        x_differ = int((Xp.view(np.uint32) != X.view(np.uint32)).sum())
        y_differ = int((yp.view(np.uint32) != y.view(np.uint32)).sum())
        del X, y, block

        # (iii) the in-core fit on the card, on the parsed rows
        with levers(SUBMIT_LEVERS):
            zero_counts(H)
            model = HistGBT(device=DEVICE, n_trees=TREES,
                            max_depth=MAX_DEPTH, n_bins=N_BINS)
            model.fit(Xp, yp)
            if DEVICE != "cpu":
                torch.cuda.synchronize()
            incore = {**read_counts(H),
                      "descend": H.descend_kernel.launches}
        require(model._bin_layout is None, "submit: a bin layout fired")
        want = model_bytes_of(model)
        cuts = os.path.join(d, "cuts.npy")
        np.save(cuts, model.cuts.cpu().numpy())
        incore_fit_s = model.last_fit_seconds
        del model, Xp, yp
        gc_cuda(torch)

        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("DMLC_", "AWS_", "S3_"))}
        env.update(PYTHONPATH=ROOT, S3_ENDPOINT=endpoint,
                   AWS_ACCESS_KEY_ID="AKIDEXAMPLE",
                   AWS_SECRET_ACCESS_KEY="chip-smoke-secret",
                   DMLC_TPU_ROUNDS_PER_DISPATCH="1")
        params = {"n_trees": TREES, "max_depth": MAX_DEPTH,
                  "n_bins": N_BINS}
        # a CPU rehearsal of the script runs the ranks on the host
        card = "cuda:0" if DEVICE == "cuda" else DEVICE
        runs = {"s3": (SUBMIT_RANKS, "gloo", "s3://bkt/higgs/"),
                "local": (1, "nccl" if DEVICE == "cuda" else "gloo", local)}
        totals = {"hist": incore["hist"],
                  "fused_round": incore["fused_round"],
                  "descend": incore["descend"]}
        # both clusters at once, sharing the card
        walls = run_submits({name: (
            {"cuts": cuts, "backend": backend, "device": card, "threads": 2,
             "params": params,
             "runs": [{"name": name, "env": SUBMIT_LEVERS,
                       "external": {"uri": uri, "num_col": FEATURES}}],
             "out": os.path.join(d, "out")}, world)
            for name, (world, backend, uri) in runs.items()}, env, d)
        per_run = {}
        for name, (world, backend, uri) in runs.items():
            ranks = []
            for r in range(world):
                with open(os.path.join(d, "out", f"{name}.{r}.json")) as f:
                    st = json.load(f)
                with open(os.path.join(d, "out", f"{name}.{r}.model"),
                          "rb") as f:
                    require(f.read() == want, f"submit {name}: rank {r}'s "
                            "model file differs from the in-core fit's")
                require(st["world"] == world,
                        f"submit {name}: rank {r} saw world {st['world']}")
                require(st["native"]["parse_libsvm"] > 0,
                        f"submit {name}: rank {r} did not parse natively "
                        f"({st['native']})")
                if name == "local":
                    require(st["native"]["prefetch_chunks"] > 0,
                            f"submit local: no native chunk read "
                            f"({st['native']})")
                for k in ("hist", "fused_round"):
                    totals[k] += st["launches"][k]
                totals["descend"] += st["descend_launches"]
                ranks.append({"native": st["native"],
                              "launches": {**st["launches"], "descend":
                                           st["descend_launches"]},
                              "fit_seconds": st["fit_seconds"],
                              "bin_seconds": st["bin_seconds"],
                              "hist_sync_bytes": st["hist_sync_bytes"]})
            per_run[name] = {"world": world, "backend": backend,
                             "wall_seconds": walls[name], "ranks": ranks}
        for k, v in totals.items():
            require(v > 0, f"{k} was never launched on the submit path")
        emit({"phase": "submit", "rows": SUBMIT_ROWS, "features": FEATURES,
              "shards": SUBMIT_SHARDS, "text_bytes": text_bytes,
              "text_seconds": text_s, "parse_seconds": parse_s,
              "parse_native_calls": parse_calls,
              "parse_threads": _native.num_threads(),
              "parse_values_differing": x_differ,
              "parse_labels_differing": y_differ,
              "incore_fit_seconds": incore_fit_s,
              "incore_launches": incore, "runs": per_run,
              "same_model_file_as_incore": True, "launches": totals,
              "phase_seconds": time.perf_counter() - t_phase,
              "nvidia_smi": smi})
        return totals
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(d, ignore_errors=True)

def codec_ab(np):
    """The resnet feed's host leg (``batch_iterator`` over the bench's
    1536 synthetic 224² records in 4 shards, batch 256) with the native
    RecordIO decode and with the Python one, in turns (native, Python,
    Python, native) in this process: ``{"native": [rec/s, rec/s],
    "python": [...]}``."""
    from dmlc_core_tpu_torch.data.image_record import batch_iterator
    from dmlc_core_tpu_torch.io import _native_io
    from dmlc_core_tpu_torch.tools.bench_resnet_feed import write_shards

    root = tempfile.mkdtemp(prefix="chip_codec_")
    out = {"native": [], "python": []}
    try:
        write_shards(root, 1536, 224)
        for route in ("native", "python", "python", "native"):
            # the Python route: the binding reports the library absent
            _native_io._lib, _native_io._load_failed = None, route == "python"
            _native_io.reset_calls()
            t0 = time.perf_counter()
            n = sum(len(labels) for _, labels in batch_iterator(
                os.path.join(root, "part-*.rec"), 0, 1, 256, (224, 224, 3)))
            rate = n / (time.perf_counter() - t0)
            decoded = _native_io.calls()["recordio_decode"]
            require(n == 1536 and (decoded > 0) == (route == "native"),
                    f"codec A/B: {route} read {n} records, {decoded} "
                    "native decodes")
            out[route].append(rate)
    finally:
        _native_io._lib, _native_io._load_failed = None, False
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_resnet(torch, np, smi):
    """(a) :func:`resnet_cross_device`; (b) ``tools/bench_resnet_feed.py``'s
    legs at full width (ResNet-50, 224², batch 256, 1536 synthetic
    records in 4 shards)."""
    from dmlc_core_tpu_torch.io import _native_io
    from dmlc_core_tpu_torch.tools import bench_resnet_feed

    t_phase = time.perf_counter()
    resnet_cross_device(torch, np, smi)
    gc_cuda(torch)
    _native_io.reset_calls()
    rec = bench_resnet_feed.run(device=DEVICE)
    codec = _native_io.calls()
    require(codec["recordio_decode"] > 0,
            f"resnet feed: the records were not decoded by the native "
            f"RecordIO codec ({codec})")
    require(rec["variant"] == "resnet50" and rec["hw"] == 224
            and rec["batch"] == 256 and rec["records"] == 1536,
            f"resnet feed: ran {rec['variant']} at {rec['hw']}², batch "
            f"{rec['batch']}, {rec['records']} records")
    require(all(math.isfinite(v) for v in rec["losses"])
            and math.isfinite(rec["e2e_last_loss"]),
            f"resnet feed: losses {rec['losses']} / {rec['e2e_last_loss']}")
    require(0.0 <= rec["e2e_stall_fraction"] <= 1.0
            and rec["e2e_steps"] == rec["records"] // rec["batch"],
            f"resnet feed: stall {rec['e2e_stall_fraction']}, "
            f"{rec['e2e_steps']} steps")
    require(rec["peak_mem_bytes"] and rec["peak_mem_bytes"] > 0,
            "resnet feed: no peak memory")
    emit({"phase": "resnet", "part": "feed", **rec,
          "native_codec_calls": codec,
          "host_pipeline_records_per_sec_by_codec": codec_ab(np),
          "phase_seconds": time.perf_counter() - t_phase})
    gc_cuda(torch)


def phase_prodsim(np, smi):
    """``python -m dmlc_core_tpu_torch.tools.check_prodsim`` as a child
    process on the card (the drill under the lock-order, race and leak
    checkers, gated on ``tools/slo/prodsim.json``): every check green.
    Returns the kernels' launches of its run — the drill process's
    (tenant fits, the stream lane's refreshes, the oracle's predicts)
    and the replicas' alive at its end (``descend``)."""
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_prodsim_")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "PRODSIM_", "FLEET_"))
           and k not in ("DMLC_TPU_ROUNDS_PER_DISPATCH", "DMLC_METRICS_SPOOL")}
    if DEVICE == "cpu":            # a rehearsal of the script on the host
        env["BENCH_FORCE_CPU"] = "1"
    env.update({f"PRODSIM_{k}_OUT": os.path.join(out, f"{k.lower()}.json")
                for k in ("METRICS", "TRACE", "RACECHECK", "LEAKCHECK",
                          "SLO")})
    env["PRODSIM_OUT"] = os.path.join(out, "drill.json")
    env["DMLC_METRICS_SPOOL"] = os.path.join(out, "spool")
    logs = {k: os.path.join(out, f"drill.{k}") for k in ("out", "err")}
    with open(logs["out"], "w") as fo, open(logs["err"], "w") as fe:
        proc = subprocess.Popen([sys.executable, "-m",
                                 "dmlc_core_tpu_torch.tools.check_prodsim"],
                                cwd=ROOT, env=env, stdout=fo, stderr=fe,
                                text=True, start_new_session=True)
        try:
            rc = proc.wait(timeout=PRODSIM_TIMEOUT)
        except subprocess.TimeoutExpired:
            # the drill and every process it started (one session)
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    wall = time.perf_counter() - t0
    with open(logs["out"]) as f:
        stdout = f.read()
    with open(logs["err"]) as f:
        stderr = f.read()
    checks = [ln for ln in stdout.splitlines()
              if ln.startswith(("ok:", "FAIL:"))]
    require(rc == 0 and "PRODSIM DRILL GREEN" in stdout,
            f"prodsim exited {rc} after {wall:.0f} s (None: killed at "
            f"{PRODSIM_TIMEOUT} s): {checks[-3:]} stdout "
            f"{stdout[-1500:]} stderr {stderr[-6000:]}")
    with open(env["PRODSIM_OUT"]) as f:
        drill = json.load(f)
    rec = drill["record"]
    platform = "cpu" if DEVICE == "cpu" else "gpu"
    require(rec["platform"] == platform,
            f"prodsim ran on {rec['platform']}, not {platform}")
    parent = rec["kernel_launches"]["parent"]
    replicas = rec["kernel_launches"]["replicas"]
    served = sum((d or {}).get("descend", 0) for d in replicas.values())
    launches = {"hist": parent["hist"], "fused_round": parent["fused_round"],
                "descend": parent["descend"] + served}
    if platform == "gpu":
        for k, v in launches.items():
            require(v > 0, f"{k} was never launched on the prodsim path "
                           f"({parent}, replicas {replicas})")
    score = drill["slo"]
    emit({"phase": "prodsim", "availability": rec["availability"],
          "dropped": rec["dropped"], "wrong": rec["wrong"],
          "tiers_faulted": rec["chaos"]["tiers_faulted"],
          "chaos_log": rec["chaos"]["log"],
          "launch": rec["launch"], "ps_restored_version":
          rec["ps"]["restored_version"],
          "stream": {k: rec["stream"][k] for k in
                     ("refreshes", "activated", "resyncs",
                      "staleness_seconds", "live_verified")},
          "rollback": rec["rollback"], "jitcheck": rec["jitcheck"],
          "observability": drill["observability"],
          "scorecard": {"pass": score["pass"],
                        "objectives": {o["name"]: [o["observed"], o["op"],
                                                   o["threshold"]]
                                       for o in score["objectives"]}},
          "checks": len(checks), "kernel_launches": rec["kernel_launches"],
          "loadgen": {k: rec["loadgen"][k] for k in
                      ("count", "throughput_rps", "latency_p50_ms",
                       "latency_p99_ms")},
          "drill_elapsed_s": rec["elapsed_s"], "child_wall_seconds": wall,
          "nvidia_smi": smi})
    shutil.rmtree(out, ignore_errors=True)
    return launches

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
    phase_deep_kernels(torch, H, rates, mats)
    floor = phase_hist_floor(torch, np, H, rates, tc_rate)
    attention, ulysses_shape = phase_attention_kernels(torch, A, rates,
                                                       tc_rate)
    bert_launches, first_loss = phase_bert(torch, np, A, rates)
    ulysses_launches = phase_bert_parallel(torch, np, A, smi, first_loss)
    for k, v in bert_launches.items():
        require(v > 0, f"{k} was never launched on the BERT path")
        require(ulysses_launches[k] > 0,
                f"{k} was never launched on the Ulysses path")
        launches[k] = v + ulysses_launches[k]
        attention[k]["launches_bert"] = v
        attention[k]["launches_ulysses"] = ulysses_launches[k]
        attention[k]["ulysses_B_S_H_D"] = list(ulysses_shape[k]["shape"])
        for x in ("ms", "device_ms", "bound_ms", "max_abs_err"):
            attention[k][f"ulysses_{x}"] = ulysses_shape[k][x]
        attention[k]["max_abs_err"] = max(attention[k]["max_abs_err"],
                                          ulysses_shape[k]["max_abs_err"])
    kernels.update(attention)
    phase_sparse(torch, np, smi)
    Xl, yl, lin_model = phase_linear(torch, np, smi)
    fm_model = phase_fm(torch, np, smi, Xl, yl)
    sparse_model = phase_sklearn(torch, np, smi, Xl, yl)
    kernels["descend"], launches["descend"] = phase_serve(
        torch, np, H, rates, smi, Xv, lossguide_fit[1], main_fit[2],
        {"gblinear": (lin_model, Xl), "fm": (fm_model, Xl),
         "sparse": (sparse_model, Xl)})
    require(launches["descend"] > 0, "descend was never launched on the "
            "serve path")
    del Xl, yl, lin_model, fm_model, sparse_model
    launches["descend"] += phase_tenancy(torch, np, H, smi)
    launches["descend"] += phase_fleet(torch, np, H, smi)
    stream_launches, stream_errs = phase_stream(torch, np, H, smi)
    for k, v in stream_launches.items():
        require(v > 0, f"{k} was never launched on the stream path")
        launches[k] += v
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"],
                                        stream_errs[k])
    phase_ps(torch, np, smi)
    phase_recovery(torch, np, H, smi, X, y, lossguide_fit[1])
    del X, y
    for k, v in phase_submit(torch, np, H, smi).items():
        launches[k] += v
        kernels[k]["launches_submit"] = v
    phase_resnet(torch, np, smi)
    for k, v in phase_prodsim(np, smi).items():
        launches[k] += v
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
                # B2's descend alone: predict's, so a served batch's
                "descend": "dmlc_core_tpu/ops/histogram.py:531",
                "flash_fwd": f"{lib}:331",
                "flash_bwd_dkv": f"{lib}:796",
                "flash_bwd_dq": f"{lib}:1146",
                **{k: "scripts/spike_hist_floor.py:55" for k in floor}}
    extra = ("unfused_chain_ms", "chain_device_ms", "device_ms",
             "library_call", "library_device_ms", "by_n_build",
             "launches_bert", "launches_ulysses", "launches_submit",
             "ulysses_B_S_H_D",
             "ulysses_ms", "ulysses_device_ms", "ulysses_bound_ms",
             "ulysses_max_abs_err")
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
