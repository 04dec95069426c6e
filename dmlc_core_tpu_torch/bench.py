#!/usr/bin/env python3
"""Benchmark of the port: hist-GBT boosting rounds/s per GPU.

    python -m dmlc_core_tpu_torch.bench

The flagship mode of the repository's ``bench.py``, on the port: HIGGS-like
synthetic data — ``BENCH_ROWS`` (10M) × ``BENCH_FEATURES`` (28) dense
gaussians, a nonlinear binary label, seed 7 — cut into ``BENCH_BINS``
(256) quantile bins on the host, binned on the host and uploaded as uint8,
then ``BENCH_ROUNDS`` (100) boosting rounds of depth ``BENCH_DEPTH`` (6)
after ``BENCH_WARMUP`` (10) discarded warmup rounds.  The levers are
``bench.py``'s, set by ``setdefault`` so that any can be turned off from
the environment: ``DMLC_BIN_PACK=1``, ``DMLC_FEATURE_BUNDLE=1``,
``DMLC_GROW_POLICY=lossguide``, ``DMLC_MAX_LEAVES=16`` (``2^(depth−2)``)
and ``DMLC_TPU_BIN_BACKEND=cpu``.  It runs on the GPU; ``BENCH_FORCE_CPU=1``
pins the CPU (a rehearsal with the kernels' plain versions, whose rate is
no device metric); without it and without a GPU the run fails.

Output protocol (``bench.py``'s): a provisional JSON line at every phase
and at every timed chunk's arrival, then one final line, all under
``bench.py``'s field names; the metric is
``histgbt_rounds_per_sec_per_chip``.  ``BENCH_TIME_BUDGET`` (s, default
480) is enforced by a watchdog thread that flushes the evidence so far as
the final line and exits 0; SIGTERM/SIGINT flush the same way.  Rows fall
back 10M → 4M → 2M → 1M → 250k when the budget cannot fit the set-up
(``BENCH_NO_FALLBACK=1`` pins them).  A run whose chunks disagree by more
than 3× (``chunk_stats``' anomaly) is measured again on the resident data,
and the official run is the first that is not anomalous.  After the
headline, the JAX bench's infeed smoke (24 ``[2048, 128]`` f32 batches
through ``data.device_feed.DeviceFeed``) fills ``infeed_stall_frac``.

``--serve`` is the JAX bench's serving mode (:func:`_serve_bench`): a
depth-4, 64-bin ``HistGBT`` of ``SERVE_TREES`` (20) trees on
``SERVE_TRAIN_ROWS`` (50,000) rows, published to a ``ModelRegistry``,
every bucket warmed, then Poisson arrivals at ``SERVE_QPS`` (300) for
``SERVE_SECONDS`` (10) through a ``DynamicBatcher`` (``SERVE_MAX_BATCH``
256, ``SERVE_MAX_DELAY_MS`` 2, request sizes from ``SERVE_REQ_SIZES``,
default ``1,1,1,1,2,4,8,16``); metric ``serve_requests_per_sec`` with
``bench.py``'s record fields, plus ``descend_kernel``'s launches per
served batch.  ``BENCH_FORCE_CPU=1`` runs it on the CPU.

``--fleet`` is the JAX bench's fleet mode (:func:`_fleet_bench`): v1 (5
trees) and v2 (10 trees) depth-4, 32-bin ``HistGBT`` models on
``FLEET_TRAIN_ROWS`` (20,000) rows, ``FLEET_REPLICAS`` (3) replica
processes supervised by a ``LauncherScaler`` JobSet behind a
``FleetRouter``, closed-loop load from ``FLEET_PROCS`` (2) ×
``FLEET_THREADS`` (3) clients at ``FLEET_QPS`` (120) for ``FLEET_SECONDS``
(8) with a staged rollout to v2 a third of the way in; metric
``fleet_requests_per_sec``.  The replicas share the one card
(``FLEET_DEVICE`` unset: ``cuda``); under ``BENCH_FORCE_CPU`` they get
``FLEET_DEVICE=cpu``.  ``--tenants`` is the JAX bench's tenancy mode
(:func:`_tenants_bench`): ``TENANTS_N`` (12) ``HistGBT`` tenants in one
``TenantRegistry`` capped at ``TENANTS_RESIDENT_CAP`` (4) resident
runners, ``TENANTS_THREADS`` (4) threads drawing tenants from a bounded
Zipf (``TENANTS_ZIPF_A`` 1.1) for ``TENANTS_SECONDS`` (6); metric
``tenant_requests_per_sec``, plus ``descend_kernel``'s launches per
served batch on a card.

``--stream`` is the JAX bench's online-learning mode
(:func:`_stream_bench`): a generator thread appends events at
``STREAM_EVENTS_PER_SEC`` (1500) to a growing RecordIO shard set while an
``OnlineTrainer`` refreshes a depth-4, 32-bin ``HistGBT`` by
``STREAM_TREES`` (5) trees on a window of ``STREAM_WINDOW_CHUNKS`` (2)
chunks of ``STREAM_CHUNK_ROWS`` (1024) rows × ``BENCH_FEATURES`` (28),
gated and hot-swapped by a ``ModelPublisher``, for ``STREAM_SECONDS``
(10); metric ``stream_staleness_seconds`` (event appended → an activated
version trained on it, p50/p95/p99).  ``--ps`` is the JAX bench's
parameter-server mode (:func:`_ps_bench`): an in-process scheduler,
``PS_SERVERS`` (2) servers and ``PS_WORKERS`` (2) worker threads running
``GBLinear.fit_ps`` over a 10M-feature hashed CTR stream of
``PS_ROWS`` (40,000) rows of ``PS_NNZ`` (32) ids; record
``keys_per_sec``, ``staleness_p95``, ``staleness_max``,
``staleness_bound``.  The flagship record's ``kvstore_sync_ms`` is the
JAX bench's kvstore smoke on the port (:func:`_smoke_kvstore`).

Not in this module (the JAX bench's other modes): ``BENCH_CHIPS > 1`` and
its scaling probe, ``--prodsim``, the SLO scorecard and jitcheck's
``recompiles_steady_state`` (the port compiles nothing).  The record
leaves their fields out, or writes null with a note.
"""

import functools
import json
import os
import signal
import sys
import threading
import time

import numpy as np

_COMPARATOR = 2.0          # rounds/s/chip, BASELINE.md mid-band (XGBoost)
# RLock: a SIGTERM handler runs ON the main thread and re-enters emit()
# if the signal lands mid-print; a plain Lock would self-deadlock there
_EMIT_LOCK = threading.RLock()

#: bf16 tensor-core peak per platform for the MFU line.  The port's
#: histogram is integer atomics, no matrix product, so no platform has an
#: entry and ``mfu`` is null (bench.py's rule for an unknown platform).
_PEAK_BF16: dict = {}

#: set-up rates of the machine the port's bench runs on, from the phase
#: times of its own record at 10M x 28 (one H100 80GB HBM3 at 700 W with
#: 8 host cores): numpy datagen 7.6 s for the 1.12 GB of f32 features;
#: host cuts, searchsorted binning on one core and the uint8 upload
#: 31.7 s; the kernel build (~5 s of nvcc, when not hidden behind datagen)
#: with the discarded rounds and start-up; a lossguide round at 10M rows
#: 0.045-0.057 s, rounded up
_DATAGEN_BPS = 140e6
_HOST_PREP_BPS = 35e6
_BUILD_WARM_S = 10.0
#: seconds of budget the infeed and kvstore smokes need left (the JAX
#: bench's floors)
_INFEED_FLOOR_S = 75
_KVSTORE_FLOOR_S = 60
_ROUND_S_PER_ROW = 6e-9

#: the JAX bench's modes this module does not have
_NOT_PORTED_MODES = ("--prodsim", "--scaling-probe")

#: single shared evidence store; emit() renders it as one JSON line.
#: Written only by the main thread; read by the watchdog thread and
#: signal handlers.  Container VALUES are only ever rebound wholesale
#: (list .append aside), so a concurrent emit() never sees a dict change
#: size under iteration.
EV = {
    "phase": "start",
    "t0": None,              # process start (time.time())
    "config": {},            # rows/feats/rounds/... once chosen
    "platform": None,
    "chunk_times": [],       # (rounds_done, elapsed_s) of the LIVE run
    "runs": [],              # completed run evidence dicts
    "official": None,        # final selection
    "value_basis": None,
    "fallback_from": None,
    "smoke": {},
    "notes": [],
}


def _elapsed():
    return time.time() - EV["t0"] if EV["t0"] else 0.0


def _live_estimate():
    """Per-chip rate estimate from the in-flight run's chunk arrivals."""
    ct = EV["chunk_times"]
    if not ct:
        return None
    done, t = ct[-1]
    if t <= 0:
        return None
    return done / t / EV["config"].get("chips", 1)


def _metrics_out_path():
    """--metrics-out PATH / --metrics-out=PATH / BENCH_METRICS_OUT env —
    where to archive the full metrics snapshot (None = don't)."""
    for i, a in enumerate(sys.argv):
        if a == "--metrics-out" and i + 1 < len(sys.argv):
            return sys.argv[i + 1]
        if a.startswith("--metrics-out="):
            return a.split("=", 1)[1]
    return os.environ.get("BENCH_METRICS_OUT")


def _attach_metrics(out):
    """Final-record metrics from the port's registry: the snapshot
    archived where ``--metrics-out`` / ``BENCH_METRICS_OUT`` says, and a
    compact summary inline (phase p50s and counts, rounds, collective and
    histogram-sync bytes).  The JAX record's retry, fault-injection,
    spool and recompile fields have no counterpart in the port and are
    left out.  Never fatal: the headline record must survive."""
    try:
        from dmlc_core_tpu_torch.base.metrics import default_registry

        reg = default_registry()
        path = _metrics_out_path()
        if path:
            out["metrics_path"] = reg.save_json(path)
        snap = reg.snapshot()["metrics"]
        summary = {}
        ph = snap.get("dmlc_gbt_phase_seconds")
        if ph:
            for se in ph["series"]:
                lab = se["labels"]
                key = f"{lab['engine']}_{lab['phase']}"
                summary[f"{key}_p50_s"] = se["quantiles"]["p50"]
                summary[f"{key}_count"] = se["count"]
        for name, field in (("dmlc_gbt_rounds_total", "rounds_total"),
                            ("dmlc_collective_bytes_total",
                             "collective_bytes_total"),
                            ("dmlc_histogram_psum_bytes_total",
                             "histogram_psum_bytes_total")):
            m = snap.get(name)
            if m and m["series"]:
                summary[field] = sum(s["value"] for s in m["series"])
        out["metrics_summary"] = summary
    except Exception as e:  # noqa: BLE001
        out["metrics_error"] = f"{type(e).__name__}: {e}"[:200]


def _smoke_infeed(dev):
    """The JAX bench's infeed smoke: the ``DeviceFeed`` stall fraction on
    24 synthetic ``[2048, 128]`` f32 batches (seed 1), each consumed by
    ``sum(tanh(x @ w))`` on ``dev``."""
    import torch

    from dmlc_core_tpu_torch.data.device_feed import DeviceFeed

    rng = np.random.default_rng(1)
    n_batches, B, D = 24, 2048, 128

    def host_iter():
        for _ in range(n_batches):
            yield (rng.normal(size=(B, D)).astype(np.float32),)

    w = torch.from_numpy(rng.normal(size=(D, D)).astype(np.float32)).to(dev)
    out = None
    with DeviceFeed(host_iter, dev, depth=2) as feed:
        for (x,) in feed:
            out = torch.sum(torch.tanh(x @ w))
        out.item()               # a real fetch: the pipe drained
        return round(feed.stats.stall_fraction(), 4)


def _smoke_kvstore(dev):
    """The JAX bench's kvstore smoke: fused dist_sync push+pull ms/step
    on a small BERT-shaped key set (an embedding and 12 layers of two
    matrices and a bias, hidden 128), median of 3 repeats of 3 steps.
    The pull's collective needs a process group behind the store's
    mesh: without one, a group of one on this device (NCCL on a card,
    gloo on the CPU) is made for the smoke and taken down after it."""
    import torch
    import torch.distributed as dist

    from dmlc_core_tpu_torch.parallel.kvstore import KVStore
    from dmlc_core_tpu_torch.parallel.launch import free_port

    hidden = 128
    shapes = [("embed", (4000, hidden))]
    for i in range(12):
        shapes += [(f"l{i}.w1", (hidden, 4 * hidden)),
                   (f"l{i}.w2", (4 * hidden, hidden)),
                   (f"l{i}.b", (hidden,))]
    rng = np.random.default_rng(2)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
            rank=0)
    try:
        grads = {k: torch.from_numpy(rng.normal(size=s).astype(
            np.float32)).to(dev) for k, s in shapes}
        kv = KVStore.create("dist_sync", learning_rate=0.01, device=dev)
        keys = [k for k, _ in shapes]
        kv.init(keys, [np.zeros(s, np.float32) for _, s in shapes])

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        kv.push(keys, [grads[k] for k in keys])      # first use of each op
        kv.pull(keys)
        sync()
        steps, reps = 3, []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                kv.push(keys, [grads[k] for k in keys])
                kv.pull(keys)
            sync()
            reps.append((time.perf_counter() - t0) / steps * 1e3)
        return round(sorted(reps)[1], 3)
    finally:
        if own:
            dist.destroy_process_group()


def emit(final=False, **extra):
    """Print one JSON evidence line (a reader takes the LAST line)."""
    cfg = EV["config"]
    value = 0.0
    basis = None
    if EV["official"] is not None:
        value = EV["official"]["value"]
        basis = EV["value_basis"]
    else:
        live = _live_estimate()
        if live is not None:
            value = live
            basis = "wall_so_far"
    out = {
        "metric": "histgbt_rounds_per_sec_per_chip",
        "value": round(value, 4),
        "unit": "rounds/s/chip",
        "vs_baseline": round(value / _COMPARATOR, 4),
        "provisional": not final,
        "phase": EV["phase"],
        "elapsed_s": round(_elapsed(), 1),
        "platform": EV["platform"],
    }
    if basis:
        out["value_basis"] = basis
    out.update(cfg)
    if EV["fallback_from"]:
        out["fallback_from"] = EV["fallback_from"]
    if EV["chunk_times"] and EV["official"] is None:
        out["chunks_so_far"] = [[d, round(t, 3)] for d, t in
                                EV["chunk_times"]]
    if EV["official"] is not None:
        out.update(EV["official"])
        out["value"] = round(value, 4)
        out["vs_baseline"] = round(value / _COMPARATOR, 4)
        out["vs_baseline_band"] = [round(value / 4.0, 4),
                                   round(value / 2.0, 4)]
        out["runs"] = EV["runs"]
    for k, v in EV["smoke"].items():
        out[k] = v
    if EV["notes"]:
        out["notes"] = EV["notes"]
    if final:
        _attach_metrics(out)
    out.update(extra)
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(out) + "\n")
        sys.stdout.flush()


def _flush_and_exit(reason):
    try:
        emit(final=True, terminated=reason)
    except Exception as e:  # noqa: BLE001 — the record must still exist
        with _EMIT_LOCK:
            sys.stdout.write(json.dumps({
                "metric": "histgbt_rounds_per_sec_per_chip",
                "value": 0.0, "unit": "rounds/s/chip", "vs_baseline": 0.0,
                "terminated": reason, "provisional": False,
                "emit_error": f"{type(e).__name__}: {e}"[:200]}) + "\n")
            sys.stdout.flush()
    os._exit(0)


def _install_guards(deadline):
    """SIGTERM/SIGINT flush + a watchdog thread enforcing the deadline (a
    thread, not SIGALRM: a signal handler runs only between bytecodes on
    the main thread, which may sit in a long native call)."""
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda s, f: _flush_and_exit(
            signal.Signals(s).name))

    def watch():
        while True:
            left = deadline - time.time()
            if left <= 0:
                _flush_and_exit("budget_exhausted")
            time.sleep(min(5.0, max(0.5, left)))

    threading.Thread(target=watch, daemon=True).start()


def _derived_metrics(rows, feats, depth, n_bins, seconds_per_round, platform,
                     n_chips=1, layout=None, grow_policy="depthwise",
                     max_leaves=0, fused=False, quant=False):
    """``bench.py``'s per-round cost model, field for field.

    ``mxu_flops_per_round`` is the JAX kernel's one-hot product count
    (``2·A·lo·rows·F`` per level, ``A = 2·n_build·hi``, ``lo`` by
    ``_lo_factor``), a model of the reference's work: the port's
    histogram does no matrix product, so ``mfu`` is null.  HBM bytes: the
    bin-matrix passes of one round at the physical row width
    (``bins_bytes_per_round``) plus the f32 row vectors.  ``kernel``
    reports the port's own dispatch."""
    from dmlc_core_tpu_torch.ops.histogram import (_lo_factor,
                                                   bins_bytes_per_round,
                                                   hist_psum_bytes_per_round,
                                                   leaves_built_per_round)

    rows = rows // n_chips
    mxu_flops = 0
    psum_bytes = hist_psum_bytes_per_round(
        depth, feats, n_bins, layout=layout, grow_policy=grow_policy,
        max_leaves=max_leaves, quant=quant)
    sync_bins = layout.sync_bins if layout is not None else n_bins
    for level in range(depth):
        n_build = 1 if level == 0 else 1 << (level - 1)
        lo = _lo_factor(n_build, sync_bins)
        hi = -(-sync_bins // lo)
        mxu_flops += 2 * (2 * n_build * hi) * lo * rows * feats
    row_bytes = layout.phys_rows if layout is not None else feats
    leaves_built = leaves_built_per_round(depth, grow_policy, max_leaves)
    bins_bytes = bins_bytes_per_round(
        depth, rows, row_bytes, grow_policy=grow_policy,
        max_leaves=max_leaves, fused=fused)
    hbm = bins_bytes + 6 * rows * 4       # + g/h/preds/update f32 vectors
    peak = _PEAK_BF16.get(platform, 0)
    mfu = (mxu_flops / seconds_per_round / peak) if peak else None
    return {
        "mxu_flops_per_round": mxu_flops,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "hbm_bytes_per_round": hbm,
        "hbm_gbps": round(hbm / seconds_per_round / 1e9, 1),
        "hist_psum_bytes_per_round": psum_bytes,
        "kernel": {
            "bins_bytes_per_round": bins_bytes,
            "bin_bytes_per_data_row": row_bytes,
            "leaves_built_per_round": leaves_built,
            "grow_policy": grow_policy,
            "bin_layout": (None if layout is None else
                           f"{layout.n_features}F->{layout.phys_rows}rows"
                           f"/{len(layout.pairs)}pairs"),
            "fused_round": fused,
            "hist_quant": quant,
        },
    }


def chunk_stats(chunk_times, total_rounds, total_seconds):
    """Per-chunk rate evidence from (rounds_done, t) arrival timestamps.

    Returns best/median/worst seconds-per-round and the anomaly flag
    (worst/best > 3 AND worst > 50 ms/round — a stalled dispatch is the
    signature; the absolute floor stops a near-zero timer delta on a fast
    local fit from flagging its sibling chunks as "slow").  Deltas are
    clamped to 1 µs so a coarse timer never divides by zero.  Pure, as
    ``bench.py``'s."""
    eps = 1e-6
    spr = []
    prev_done, prev_t = 0, 0.0
    for done_i, t_i in chunk_times:
        spr.append(max(t_i - prev_t, eps) / (done_i - prev_done))
        prev_done, prev_t = done_i, t_i
    # wall fallback only when there is no chunk evidence at all
    spr_sorted = sorted(spr) or [total_seconds / total_rounds]
    med = spr_sorted[len(spr_sorted) // 2]
    return {
        "chunk_seconds_per_round": [round(s, 5) for s in spr],
        "rounds_per_sec_best_chunk": round(1.0 / spr_sorted[0], 4),
        "rounds_per_sec_median_chunk": round(1.0 / med, 4),
        "anomaly": (len(spr) >= 2
                    and spr_sorted[-1] / spr_sorted[0] > 3.0
                    and spr_sorted[-1] > 0.05),
    }


def scaling_summary(n_chips, per_chip_rate, baseline_rate):
    """Multi-chip scaling evidence vs the 1-chip run:
    ``scaling_efficiency`` = per-chip rate at N chips / 1-chip rate.
    Pure, as ``bench.py``'s (the port's bench runs one GPU; kept for the
    records' shared tooling)."""
    if not baseline_rate or baseline_rate <= 0 or n_chips < 1:
        return None
    return {
        "chips": n_chips,
        "baseline_chips": 1,
        "baseline_rounds_per_sec_per_chip": round(baseline_rate, 4),
        "aggregate_rounds_per_sec": round(per_chip_rate * n_chips, 4),
        "scaling_efficiency": round(per_chip_rate / baseline_rate, 4),
    }


def _setup_estimate(rows, feats, rounds):
    """Pessimistic seconds to reach the end of the timed fit on this
    machine: datagen + host cuts, binning and the uint8 upload + the
    kernel build and warmup rounds + the fit at the measured per-row
    rate."""
    datagen = rows * feats * 4 / _DATAGEN_BPS
    host_prep = rows * feats * 4 / _HOST_PREP_BPS
    spr = max(rows * _ROUND_S_PER_ROW, 0.005)
    return datagen + host_prep + _BUILD_WARM_S + rounds * spr


def _host_cuts(X, n_bins, sample=2_000_000):
    """Sampled per-feature quantile cuts on the HOST (``bench.py``'s)."""
    step = max(1, len(X) // sample)
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.ascontiguousarray(
        np.quantile(X[::step], qs, axis=0).T.astype(np.float32))


def _pick_config(budget_left):
    """Choose rows/rounds that fit the remaining budget (with margin for
    the final lines), falling back from the requested config and
    recording the decision."""
    rows = int(os.environ.get("BENCH_ROWS", 10_000_000))
    feats = int(os.environ.get("BENCH_FEATURES", 28))
    rounds = int(os.environ.get("BENCH_ROUNDS", 100))
    requested = rows
    if os.environ.get("BENCH_NO_FALLBACK"):
        return rows, feats, rounds
    chain = [requested] + [c for c in (4_000_000, 2_000_000, 1_000_000,
                                       250_000) if c < requested]
    for cand in chain:
        if _setup_estimate(cand, feats, rounds) <= budget_left - 60:
            rows = cand
            break
    else:
        rows = chain[-1]
    if rows != requested:
        EV["fallback_from"] = requested
        EV["notes"].append(
            f"budget {budget_left:.0f}s left cannot fit rows={requested} "
            f"(est {_setup_estimate(requested, feats, rounds):.0f}s); "
            f"fell back to rows={rows}")
    if _setup_estimate(rows, feats, rounds) > budget_left - 60:
        setup_only = _setup_estimate(rows, feats, 0)
        spr = max(rows * _ROUND_S_PER_ROW, 0.005)
        fit_window = budget_left - 60 - setup_only
        new_rounds = max(25, int(fit_window / spr)) if fit_window > 0 else 25
        if new_rounds < rounds:
            EV["notes"].append(
                f"rounds fallback {rounds}->{new_rounds}: setup alone "
                f"needs ~{setup_only:.0f}s of the {budget_left:.0f}s left")
            rounds = new_rounds
    return rows, feats, rounds


def _launch_counts(H):
    return {"hist": H.hist_kernel.launches,
            "hist_layout": H.hist_kernel.layout_launches,
            "fused_round": H.fused_round_kernel.launches,
            "fused_round_layout": H.fused_round_kernel.layout_launches,
            "fused_descend": H.fused_descend_kernel.launches}


def main() -> None:
    EV["t0"] = time.time()
    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))
    deadline = EV["t0"] + budget
    _install_guards(deadline)

    warmup = int(os.environ.get("BENCH_WARMUP", 10))
    depth = int(os.environ.get("BENCH_DEPTH", 6))
    n_bins = int(os.environ.get("BENCH_BINS", 256))

    # the flagship's levers, as bench.py sets them: int4 bin packing,
    # exclusive-feature bundling, loss-guide growth at 2^(depth-2) leaves
    os.environ.setdefault("DMLC_BIN_PACK", "1")
    os.environ.setdefault("DMLC_FEATURE_BUNDLE", "1")
    os.environ.setdefault("DMLC_GROW_POLICY", "lossguide")
    os.environ.setdefault("DMLC_MAX_LEAVES", str(max(1 << (depth - 2), 4)))

    import torch

    from dmlc_core_tpu_torch.models.histgbt import (HistGBT,
                                                    _fused_round_engaged)
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                  resolve_device)

    EV["phase"] = "probe"
    emit()
    try:
        dev = resolve_device("cpu" if os.environ.get("BENCH_FORCE_CPU")
                             else None)
    except Exception as e:
        emit(final=True, error=f"{type(e).__name__}: {e}"[:500])
        raise
    EV["platform"] = "gpu" if dev.type == "cuda" else "cpu"
    card = ({"device_kind": torch.cuda.get_device_name(dev),
             "nvidia_smi": gpu_name_and_power_limit()}
            if dev.type == "cuda" else {})
    if int(os.environ.get("BENCH_CHIPS", "0") or 0) > 1:
        EV["notes"].append("BENCH_CHIPS > 1 is not ported: one GPU")

    rows, feats, rounds = _pick_config(deadline - time.time())
    EV["config"] = {"rows": rows, "features": feats, "rounds": rounds,
                    "max_depth": depth, "n_bins": n_bins,
                    "levers": {
                        "bin_pack": os.environ["DMLC_BIN_PACK"] == "1",
                        "feature_bundle":
                            os.environ["DMLC_FEATURE_BUNDLE"] == "1",
                        "grow_policy": os.environ["DMLC_GROW_POLICY"],
                        "max_leaves":
                            int(os.environ["DMLC_MAX_LEAVES"] or 0),
                        "fused_round":
                            os.environ.get("DMLC_FUSED_ROUND", "auto"),
                        "hist_quant":
                            os.environ.get("DMLC_HIST_QUANT", "0") == "1",
                    },
                    "chips": 1, **card}
    n_chips = 1
    model = HistGBT(n_trees=rounds, max_depth=depth, n_bins=n_bins,
                    learning_rate=0.1, device=dev)
    # cold-start overlap: the kernels' build and load start NOW, beside
    # datagen, cuts and binning
    model.start_warmup(rows, feats)
    EV["phase"] = "datagen"
    emit()

    # HIGGS-like synthetic: dense gaussians + a nonlinear decision rule
    rng = np.random.default_rng(7)
    X = rng.normal(size=(rows, feats)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    y = (margin > 0).astype(np.float32)

    EV["phase"] = "prepare"      # cuts + bin on host, uint8 upload: setup
    emit()
    os.environ.setdefault("DMLC_TPU_BIN_BACKEND", "cpu")
    dd = model.make_device_data(X, y, cuts=_host_cuts(X, n_bins))
    del X, y, margin
    EV["config"] = {**EV["config"],
                    "bin_seconds": round(model.last_bin_seconds or 0.0, 3)}

    def _run_once(warmup_rounds):
        """One timed fit on the device-resident handle; returns an
        evidence dict with per-chunk rates (each chunk's arrival emits a
        provisional line)."""
        EV["chunk_times"] = []

        def cb(done, t_s):
            EV["chunk_times"].append((done, t_s))
            emit()

        before = _launch_counts(H)
        model.fit_device(dd, warmup_rounds=warmup_rounds, chunk_callback=cb)
        seconds = model.last_fit_seconds
        out = {
            "seconds": round(seconds, 3),
            "warmup_seconds": round(model.last_warmup_seconds, 3),
            "rounds_done": len(model.trees),
        }
        if model.last_compile_seconds is not None:
            out["compile_seconds"] = round(model.last_compile_seconds, 3)
        if model.last_warm_dispatch_seconds is not None:
            out["warm_dispatch_seconds"] = round(
                model.last_warm_dispatch_seconds, 3)
        if model.last_warmup_breakdown is not None:
            out["warmup_breakdown"] = model.last_warmup_breakdown
        out["compile_cache"] = model.last_compile_cache or "warm"
        out.update(chunk_stats(model.last_chunk_times, rounds, seconds))
        if model.last_chunk_times:
            out["time_to_first_tree"] = round(
                model.last_warmup_seconds + model.last_chunk_times[0][1],
                3)
        out["wall_rounds_per_sec"] = round(rounds / seconds / n_chips, 4)
        after = _launch_counts(H)
        # kernel launches of this run (warmup rounds included): what the
        # port dispatched on a CUDA device, 0 on the CPU
        out["kernel_launches"] = {k: after[k] - before[k] for k in after}
        return out

    EV["phase"] = "warmup+timed"
    emit()
    try:
        runs = [_run_once(warmup)]
        EV["runs"] = runs
        if runs[0]["anomaly"]:
            est = runs[0]["seconds"] * 1.5 + 30
            if deadline - time.time() > est:
                EV["notes"].append("chunk-rate anomaly: re-measuring once "
                                   "on resident data")
                emit()
                try:
                    runs.append(_run_once(1))
                except Exception as e:  # noqa: BLE001
                    EV["notes"].append(
                        f"re-measure failed ({type(e).__name__}: {e}), "
                        "keeping first run")
            else:
                EV["notes"].append(
                    f"chunk-rate anomaly but only "
                    f"{deadline - time.time():.0f}s budget left "
                    f"(< {est:.0f}s): re-measure skipped")
    except Exception as e:  # noqa: BLE001 — bench must always emit a line
        emit(final=True, error=f"{type(e).__name__}: {e}"[:500])
        os._exit(3)

    # official selection: the FIRST non-anomalous run (never best-of-2);
    # if every run is anomalous, the best run's MEDIAN-chunk rate
    non_anom = [r for r in runs if not r["anomaly"]]
    if non_anom:
        official = dict(non_anom[0])
        value = official["wall_rounds_per_sec"]
        EV["value_basis"] = "wall"
    else:
        official = dict(max(
            runs, key=lambda r: r["rounds_per_sec_median_chunk"]))
        value = official["rounds_per_sec_median_chunk"] / n_chips
        EV["value_basis"] = "median_chunk"
    official["value"] = value
    official.update(_derived_metrics(
        rows, feats, depth, n_bins, 1.0 / (value * n_chips),
        EV["platform"], n_chips, layout=model._bin_layout,
        grow_policy=os.environ.get("DMLC_GROW_POLICY", "depthwise"),
        max_leaves=int(os.environ.get("DMLC_MAX_LEAVES", "0") or 0),
        fused=_fused_round_engaged(n_chips), quant=False))
    official["kernel"]["launches"] = official["kernel_launches"]
    EV["official"] = official
    EV["runs"] = runs
    EV["notes"].append(
        "mxu_flops_per_round is the JAX kernel's one-hot product model; "
        "the port's histogram does no matrix product (mfu null)")
    emit()           # the headline is on stdout before the smoke fields

    EV["phase"] = "smoke"
    EV["smoke"] = {"infeed_stall_frac": None, "kvstore_sync_ms": None}
    smokes = (
        ("infeed_stall_frac", _smoke_infeed, _INFEED_FLOOR_S,
         "24 x [2048, 128] f32 batches through DeviceFeed(depth=2), "
         "consumer sum(tanh(x @ w))"),
        ("kvstore_sync_ms", _smoke_kvstore, _KVSTORE_FLOOR_S,
         "dist_sync push+pull ms/step of a BERT-shaped key set (37 keys, "
         "2.09M f32) over a process group of one on this device, median "
         "of 3 x 3 steps"))
    for name, fn, floor, basis in smokes:
        if deadline - time.time() < floor:
            EV["notes"].append(f"{name} skipped: budget")
            continue
        try:
            EV["smoke"] = {**EV["smoke"],
                           name: {"value": fn(dev), "basis": basis}}
        except Exception as e:  # noqa: BLE001
            EV["notes"].append(
                f"{name} failed: {type(e).__name__}: {e}"[:200])
    EV["notes"].append("scaling probe: not ported")
    EV["phase"] = "done"
    emit(final=True)


def latency_summary(lats_s):
    """p50/p95/p99/mean (ms) of a latency sample list — the JAX bench's
    serve percentile math, pure."""
    if not lats_s:
        return {"latency_p50_ms": None, "latency_p95_ms": None,
                "latency_p99_ms": None, "latency_mean_ms": None}
    s = sorted(lats_s)

    def q(p):
        return s[min(len(s) - 1, max(0, int(round(p * (len(s) - 1)))))]

    return {
        "latency_p50_ms": round(q(0.50) * 1e3, 3),
        "latency_p95_ms": round(q(0.95) * 1e3, 3),
        "latency_p99_ms": round(q(0.99) * 1e3, 3),
        "latency_mean_ms": round(sum(s) / len(s) * 1e3, 3),
    }


def _mode_emit(metric, rec, final=False):
    """One JSON line of a serving mode's record under ``metric`` (req/s):
    provisional until ``final``, which attaches the metrics summary."""
    rec = {"metric": metric, "unit": "req/s", "provisional": not final,
           **rec}
    if final:
        _attach_metrics(rec)
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()


_serve_emit = functools.partial(_mode_emit, "serve_requests_per_sec")
_fleet_emit = functools.partial(_mode_emit, "fleet_requests_per_sec")
_tenants_emit = functools.partial(_mode_emit, "tenant_requests_per_sec")


def _serve_bench() -> None:
    """``--serve``: open-loop load over the serve batcher and runner (the
    JAX bench's mode, field for field).

    Trains a small GBT, publishes it to a ModelRegistry, then drives the
    DynamicBatcher directly (no HTTP — the socket layer has its own
    tests) with Poisson arrivals at ``SERVE_QPS`` for ``SERVE_SECONDS``,
    request sizes drawn uniformly from ``SERVE_REQ_SIZES`` (repeat a size
    to weight it).  One provisional line per phase, then a final line
    with throughput, latency percentiles, reject counts, a batch-size
    summary and, on a card, ``descend_kernel``'s launches per batch.
    Every bucket is warmed before the timed window.  The JAX record's
    SLO scorecard has no counterpart here."""
    t0 = time.time()
    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))
    qps = float(os.environ.get("SERVE_QPS", 300))
    duration = min(float(os.environ.get("SERVE_SECONDS", 10)),
                   max(budget - 120, 2.0))
    max_batch = int(os.environ.get("SERVE_MAX_BATCH", 256))
    max_delay = float(os.environ.get("SERVE_MAX_DELAY_MS", 2.0)) / 1e3
    sizes = [int(s) for s in
             os.environ.get("SERVE_REQ_SIZES", "1,1,1,1,2,4,8,16").split(",")]
    train_rows = int(os.environ.get("SERVE_TRAIN_ROWS", 50_000))
    n_trees = int(os.environ.get("SERVE_TREES", 20))
    feats = int(os.environ.get("BENCH_FEATURES", 28))

    cfg = {"qps": qps, "duration_s": duration, "max_batch": max_batch,
           "max_delay_ms": max_delay * 1e3, "req_sizes": sizes,
           "train_rows": train_rows, "n_trees": n_trees}
    _serve_emit({"value": 0.0, "phase": "train", **cfg})

    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.serve import (DynamicBatcher, ModelRegistry,
                                           QueueFullError)

    dev, card = _bench_device(_serve_emit, cfg)

    rng = np.random.default_rng(11)
    X = rng.normal(size=(train_rows, feats)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    depth = 4
    model = HistGBT(n_trees=n_trees, max_depth=depth, n_bins=64,
                    learning_rate=0.3, device=dev)
    model.fit(X, y)

    registry = ModelRegistry(max_batch=max_batch, min_bucket=8)
    registry.publish(model, source="serve-bench")
    _, runner = registry.current()

    def execute(batch):
        version, r = registry.current()
        return r.predict(batch), version

    _serve_emit({"value": 0.0, "phase": "warmup", **cfg})
    # every ladder bucket once: the kernels' build and load, the CUDA
    # context and the allocator's blocks come before the timed window
    warm_wall = runner.warmup(feats)

    batcher = DynamicBatcher(execute, max_batch=max_batch,
                             max_delay=max_delay, max_queue=512,
                             name="serve-bench")
    lats = []
    errors = [0]
    lock = threading.Lock()

    def record(fut, t_sub):
        try:
            fut.result()
        except Exception:  # noqa: BLE001
            with lock:
                errors[0] += 1
            return
        with lock:
            lats.append(time.perf_counter() - t_sub)

    _serve_emit({"value": 0.0, "phase": "load", **cfg})
    H.descend_kernel.launches = 0
    submitted = rejected = 0
    start = time.perf_counter()
    next_t = start
    end = start + duration
    while (now := time.perf_counter()) < end:
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        next_t += rng.exponential(1.0 / qps)
        k = int(rng.choice(sizes))
        lo = int(rng.integers(0, train_rows - k))
        t_sub = time.perf_counter()
        try:
            fut = batcher.submit(X[lo:lo + k], timeout=5.0)
        except QueueFullError:
            rejected += 1
            continue
        fut.add_done_callback(lambda f, t=t_sub: record(f, t))
        submitted += 1
    batcher.close(drain=True)
    wall = time.perf_counter() - start
    descends = H.descend_kernel.launches

    # batch-size evidence straight from the serve instruments
    batch_summary = {}
    try:
        from dmlc_core_tpu_torch.base.metrics import default_registry
        snap = default_registry().snapshot()["metrics"]
        hs = snap.get("dmlc_serve_batch_rows", {}).get("series", [])
        se = next((s for s in hs
                   if s["labels"].get("batcher") == "serve-bench"), None)
        if se:
            batch_summary = {
                "batches": se["count"],
                "batch_rows_p50": se["quantiles"]["p50"],
                "batch_rows_p99": se["quantiles"]["p99"],
                "batch_rows_max": se["max"],
            }
    except Exception:  # noqa: BLE001 — evidence, not the headline
        pass
    if dev.type == "cuda" and batch_summary.get("batches"):
        batch_summary["descend_launches"] = descends
        batch_summary["descend_launches_per_batch"] = (
            descends / batch_summary["batches"])
        batch_summary["descend_launches_per_batch_expected"] = (
            n_trees * depth)

    done = len(lats)
    _serve_emit({
        "value": round(done / wall, 2) if wall > 0 else 0.0,
        "phase": "done",
        "elapsed_s": round(time.time() - t0, 1),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        **card,
        "submitted": submitted,
        "completed": done,
        "rejected": rejected,
        "errors": errors[0],
        "warmup_seconds": round(warm_wall, 3),
        **latency_summary(lats),
        **batch_summary,
        "compiled_shapes": sorted(runner.compiled_shapes),
        "shape_bound": runner.shape_bound,
        **cfg,
    }, final=True)


def _bench_device(emit_fn, cfg):
    """The run's device (``BENCH_FORCE_CPU``: the CPU) and, on a card,
    its name and power limit; without a GPU the final record carries the
    error and the run fails."""
    import torch

    from dmlc_core_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                  resolve_device)

    try:
        dev = resolve_device("cpu" if os.environ.get("BENCH_FORCE_CPU")
                             else None)
    except Exception as e:
        emit_fn({"value": 0.0, "phase": "done",
                 "error": f"{type(e).__name__}: {e}"[:500], **cfg},
                final=True)
        raise
    card = ({"device_kind": torch.cuda.get_device_name(dev),
             "nvidia_smi": gpu_name_and_power_limit()}
            if dev.type == "cuda" else {})
    return dev, card


def _fleet_bench() -> None:
    """``--fleet``: closed-loop load over a replica fleet behind the
    consistent-hash router, with a staged v1->v2 rollout mid-run (the JAX
    bench's mode, field for field).

    Trains two GBT versions, checkpoints both, then stands up the fleet —
    FleetTracker + ``FLEET_REPLICAS`` replica processes spawned through
    the launch subsystem (a :class:`LauncherScaler`-backed JobSet) +
    in-process FleetRouter — and drives it with the multi-process
    closed-loop load generator (heavy-tail request sizes, diurnal QPS
    ramp).  One third into the run a staged rollout (wave size 1)
    hot-swaps the fleet to v2 under load.  Every response is verified
    bit-exactly against the version it claims (the direct ``predict`` of
    the model on this run's device), so ``dropped``/``wrong`` are the
    zero-drop hot-swap evidence; per-replica balance and the failovers
    by reason come from the router's ``fleet_routed_total`` and
    ``fleet_failover_total`` series, the supervisor's view (respawns)
    from the ``launch`` block.  After the load each replica's
    ``/healthz`` version and 20 sequential routed predicts
    (``post_rollout``, held against the version each reports) show
    where the fleet ended.  The replicas share the run's one card: this
    measures the router and the replica processes, not scaling.  The
    JAX record's SLO scorecard has no counterpart here."""
    t0 = time.time()
    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))
    n_replicas = int(os.environ.get("FLEET_REPLICAS", 3))
    duration = min(float(os.environ.get("FLEET_SECONDS", 8)),
                   max(budget - 180, 3.0))
    qps = float(os.environ.get("FLEET_QPS", 120))
    procs = int(os.environ.get("FLEET_PROCS", 2))
    threads = int(os.environ.get("FLEET_THREADS", 3))
    train_rows = int(os.environ.get("FLEET_TRAIN_ROWS", 20_000))
    serve_rows = int(os.environ.get("FLEET_SERVE_ROWS", 512))
    feats = int(os.environ.get("BENCH_FEATURES", 28))

    cfg = {"replicas": n_replicas, "qps": qps, "duration_s": duration,
           "procs": procs, "threads": threads, "train_rows": train_rows}
    _fleet_emit({"value": 0.0, "phase": "train", **cfg})

    import tempfile

    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.serve import ResilientClient, checkpoint_model
    from dmlc_core_tpu_torch.serve.fleet import (FleetRouter, FleetTracker,
                                                 HttpFleetAdmin,
                                                 LauncherScaler, Rollout,
                                                 run_loadgen)

    dev, card = _bench_device(_fleet_emit, cfg)
    rng = np.random.default_rng(11)
    Xt = rng.normal(size=(train_rows, feats)).astype(np.float32)
    yt = (Xt[:, 0] * Xt[:, 1] + 0.5 * Xt[:, 2] > 0).astype(np.float32)
    m1 = HistGBT(n_trees=5, max_depth=4, n_bins=32, learning_rate=0.3,
                 device=dev).fit(Xt, yt)
    m2 = HistGBT(n_trees=10, max_depth=4, n_bins=32, learning_rate=0.3,
                 device=dev).fit(Xt, yt)
    X = Xt[:serve_rows]

    workdir = tempfile.mkdtemp(prefix="fleet_bench_")
    v1_uri = f"file://{workdir}/v1.ckpt"
    v2_uri = f"file://{workdir}/v2.ckpt"
    checkpoint_model(v1_uri, m1, version=1)
    checkpoint_model(v2_uri, m2, version=2)
    expected_npz = os.path.join(workdir, "expected.npz")
    direct = {1: m1.predict(X), 2: m2.predict(X)}
    np.savez(expected_npz, X=X, v1=direct[1], v2=direct[2])

    _fleet_emit({"value": 0.0, "phase": "spawn", **cfg})
    # the replicas' device: the card (FLEET_DEVICE unset), or the CPU
    # under BENCH_FORCE_CPU, as the JAX bench gives its children
    # JAX_PLATFORMS=cpu
    child_env = {"FLEET_DEVICE": "cpu"} if dev.type == "cpu" else None
    tracker = FleetTracker(nworker=max(8, n_replicas + 2))
    tracker.start()
    scaler = LauncherScaler(tracker, v1_uri, initial=n_replicas,
                            spawn_env=child_env)
    router = None
    rollout_report = {}
    try:
        deadline = time.time() + 180
        while len(tracker.serve_endpoints()) < n_replicas:
            stats = scaler.jobset.stats()
            if time.time() > deadline or any(
                    r["done"] for r in stats["ranks"].values()):
                tails = {r: scaler.jobset.log_tail(r, 1500)
                         for r in stats["ranks"]}
                raise RuntimeError(f"fleet replicas never registered: "
                                   f"{stats['ranks']} {tails}")
            time.sleep(0.2)
        router = FleetRouter(tracker, probe_s=0.2).start()

        def _rollout():
            time.sleep(duration / 3.0)
            admin = HttpFleetAdmin(tracker.serve_endpoints())
            rollout_report.update(
                Rollout(admin, wave_size=1, settle_s=0.3).run(v2_uri))

        _fleet_emit({"value": 0.0, "phase": "load", **cfg})
        roller = threading.Thread(target=_rollout, daemon=True)
        roller.start()
        merged = run_loadgen(
            router.url, expected_npz, duration_s=duration, procs=procs,
            threads=threads, base_qps=qps, amplitude=0.5,
            period_s=max(duration / 2.0, 2.0),
            timeout_ms=10_000, workdir=workdir)
        roller.join(timeout=120)

        # after the rollout: each replica's version, and sequential
        # routed answers held against the version they report (a
        # replica respawned on v1 would show in both)
        admin = HttpFleetAdmin(tracker.serve_endpoints())
        replica_versions = {str(r): admin.health(r).get("version")
                            for r in sorted(admin.replicas())}
        client = ResilientClient(router.url)
        post = {"requests": 0, "wrong": 0, "by_version": {}}
        for i in range(20):
            k = 1 + i % min(16, serve_rows)
            lo = (37 * i) % (serve_rows - k + 1)
            preds, version = client.predict(X[lo:lo + k], timeout_ms=10_000)
            want = direct.get(int(version))
            post["requests"] += 1
            post["by_version"][str(version)] = \
                post["by_version"].get(str(version), 0) + 1
            if want is None or not np.array_equal(preds, want[lo:lo + k]):
                post["wrong"] += 1

        balance, failover = {}, {}
        try:
            from dmlc_core_tpu_torch.base.metrics import default_registry
            snap = default_registry().snapshot()["metrics"]
            for se in snap.get("dmlc_fleet_routed_total",
                               {}).get("series", []):
                balance[se["labels"]["replica"]] = se["value"]
            for se in snap.get("dmlc_fleet_failover_total",
                               {}).get("series", []):
                failover[se["labels"]["reason"]] = se["value"]
        except Exception:  # noqa: BLE001 — evidence, not the headline
            pass

        _fleet_emit({
            "value": merged["throughput_rps"],
            "phase": "done",
            "elapsed_s": round(time.time() - t0, 1),
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            **card,
            "requests": merged["count"],
            "ok": merged["ok"],
            "dropped": merged["dropped"],
            "wrong": merged["wrong"],
            "by_version": merged["by_version"],
            "latency_p50_ms": merged["latency_p50_ms"],
            "latency_p95_ms": merged["latency_p95_ms"],
            "latency_p99_ms": merged["latency_p99_ms"],
            "per_replica_routed": balance,
            "failover": failover,
            "rollout": {k: rollout_report.get(k) for k in
                        ("version", "outcome", "waves")},
            "replica_versions": replica_versions,
            "post_rollout": post,
            "launch": {k: scaler.jobset.stats()[k] for k in
                       ("backend", "respawns", "spawn_ms_p95")},
            **cfg,
        }, final=True)
    finally:
        if router is not None:
            router.close()
        scaler.reap(timeout=15)
        tracker.stop()


def _tenants_bench() -> None:
    """``--tenants``: multi-tenant registry under a Zipf tenant mix (the
    JAX bench's mode, field for field).

    Publishes ``TENANTS_N`` distinct HistGBT models into one
    :class:`TenantRegistry` on the run's device, capped at
    ``TENANTS_RESIDENT_CAP`` resident runners, then drives it closed-loop
    from ``TENANTS_THREADS`` threads sampling tenants from the bounded
    Zipf law — the hot head stays warm, the long tail churns through
    eviction and page-in (a page-in rebuilds the model on the card from
    its bytes and runs the bucket ladder).  Every response is verified
    bit-exactly against the publishing model, so ``wrong`` is
    paging-correctness evidence; the final line carries per-tenant
    p50/p99, the eviction/restore totals, the page-ins' wall times and,
    on a card, ``descend_kernel``'s launches per served batch beside
    trees × depth.  The JAX record's SLO scorecard has no counterpart
    here."""
    t0 = time.time()
    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))
    n_tenants = int(os.environ.get("TENANTS_N", 12))
    cap = int(os.environ.get("TENANTS_RESIDENT_CAP", 4))
    duration = min(float(os.environ.get("TENANTS_SECONDS", 6)),
                   max(budget - 120, 2.0))
    n_threads = int(os.environ.get("TENANTS_THREADS", 4))
    zipf_a = float(os.environ.get("TENANTS_ZIPF_A", 1.1))
    train_rows = int(os.environ.get("TENANTS_TRAIN_ROWS", 4000))
    serve_rows = int(os.environ.get("TENANTS_SERVE_ROWS", 256))
    feats = int(os.environ.get("BENCH_FEATURES", 28))

    cfg = {"tenants": n_tenants, "resident_cap": cap, "zipf_a": zipf_a,
           "duration_s": duration, "threads": n_threads}
    _tenants_emit({"value": 0.0, "phase": "train", **cfg})

    from dmlc_core_tpu_torch.base.metrics import default_registry
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.serve.fleet.loadgen import (sample_tenant,
                                                         zipf_weights)
    from dmlc_core_tpu_torch.serve.tenancy import TenantRegistry

    dev, card = _bench_device(_tenants_emit, cfg)
    rng = np.random.default_rng(17)
    Xt = rng.normal(size=(train_rows, feats)).astype(np.float32)
    X = Xt[:serve_rows]
    reg = TenantRegistry(resident_cap=cap, device=dev, max_batch=64)
    names = [f"t{i:02d}" for i in range(n_tenants)]
    expected = {}
    depth = 3
    per_batch = {}
    for i, name in enumerate(names):
        yt = (Xt[:, i % feats] + 0.5 * Xt[:, (i + 1) % feats]
              > 0).astype(np.float32)
        m = HistGBT(n_trees=3 + i % 3, max_depth=depth, n_bins=32,
                    device=dev).fit(Xt, yt)
        reg.publish(name, m)
        per_batch[name] = m.param.n_trees * depth
        # HistGBT is bit-exact across batch shapes, so any prefix of
        # this full-batch oracle is THE expected answer for a request
        expected[name] = np.asarray(m.predict(X))

    # every tenant's runner has the same bucket ladder (max_batch 64)
    ladder = reg.current(names[-1])[1].shape_bound
    cum = zipf_weights(n_tenants, zipf_a)
    lat = {name: [] for name in names}   # list.append is GIL-atomic
    # the runner's batches, per thread (a shared += would lose counts)
    batches = [dict.fromkeys(names, 0) for _ in range(n_threads)]
    wrongs = [0] * n_threads
    stop = threading.Event()

    def worker(idx):
        r = np.random.default_rng(1000 + idx)
        while not stop.is_set():
            tenant = sample_tenant(r, names, cum)
            n = int(r.integers(1, serve_rows + 1))
            t1 = time.perf_counter()
            _, runner = reg.current(tenant)
            out = np.asarray(runner.predict(X[:n]))
            lat[tenant].append(time.perf_counter() - t1)
            batches[idx][tenant] += -(-n // 64)   # the runner's chunks
            if not np.array_equal(out, expected[tenant][:n]):
                wrongs[idx] += 1

    restore = default_registry().histogram("tenant_restore_seconds",
                                           labels=("tenant",))
    restores0 = {name: (restore.count(tenant=name),
                        restore.sum(tenant=name)) for name in names}
    _tenants_emit({"value": 0.0, "phase": "load", **cfg})
    H.descend_kernel.launches = 0
    workers = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_threads)]
    t_load = time.perf_counter()
    for w in workers:
        w.start()
    time.sleep(duration)
    stop.set()
    for w in workers:
        w.join(timeout=60)
    wall = time.perf_counter() - t_load
    descends = H.descend_kernel.launches

    count = sum(len(v) for v in lat.values())
    by_tenant = {}
    for name in names:
        ms = np.sort(np.asarray(lat[name], dtype=np.float64)) * 1000.0
        by_tenant[name] = {"count": int(ms.size)}
        if ms.size:
            by_tenant[name].update(
                p50_ms=round(float(np.percentile(ms, 50)), 3),
                p99_ms=round(float(np.percentile(ms, 99)), 3))
    n_in = sum(restore.count(tenant=n) - restores0[n][0] for n in names)
    s_in = sum(restore.sum(tenant=n) - restores0[n][1] for n in names)
    extra = {"page_in_seconds_mean": (s_in / n_in) if n_in else None}
    if dev.type == "cuda":
        served = {n: sum(b[n] for b in batches) for n in names}
        n_batches = sum(served.values())
        extra.update(
            descend_launches=descends, batches=n_batches,
            descend_launches_per_batch=descends / max(n_batches, 1),
            # a page-in's warmup runs the bucket ladder through the
            # kernel too; the workers' threads share the counter, so a
            # lost increment can leave the count a launch short
            descend_launches_expected=(
                sum(served[n] * per_batch[n] for n in names)
                + sum((restore.count(tenant=n) - restores0[n][0])
                      * per_batch[n] * ladder for n in names)))
    _tenants_emit({
        "value": round(count / max(wall, 1e-9), 2),
        "phase": "done",
        "elapsed_s": round(time.time() - t0, 1),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        **card,
        "requests": count,
        "wrong": sum(wrongs),
        "evictions": reg.evictions,
        "warm_restores": reg.restores,
        "resident": reg.resident(),
        "by_tenant": by_tenant,
        **extra,
        **cfg,
    }, final=True)


def _stream_emit(rec, final=False):
    """One JSON line of the stream mode's record (seconds of staleness):
    provisional until ``final``, which attaches the metrics summary."""
    rec = {"metric": "stream_staleness_seconds", "unit": "s",
           "provisional": not final, **rec}
    if final:
        _attach_metrics(rec)
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()


def _stream_bench() -> None:
    """``--stream``: closed-loop online-learning benchmark (the JAX
    bench's mode, field for field).

    A generator thread appends synthetic events (dense-event codec,
    slight concept drift) to a growing RecordIO shard set at
    ``STREAM_EVENTS_PER_SEC`` (1500); the main loop runs the full
    train→serve path — tail → warm-start boost of ``STREAM_TREES`` (5)
    trees on a window of ``STREAM_WINDOW_CHUNKS`` (2) chunks of
    ``STREAM_CHUNK_ROWS`` (1024) rows × ``BENCH_FEATURES`` (28) → gated
    publish → registry hot-swap — for ``STREAM_SECONDS`` (10).  The
    headline is **staleness**: event appended → an *activated* version
    has trained on it (p50/p95/p99 over all served events), with refresh
    throughput.  On a card the record adds the refreshes' kernel
    launches (``hist``, ``fused_round``, ``descend``).  The JAX record's
    ``recompiles_steady_state`` (its jitcheck gate) has no counterpart:
    the port compiles nothing, so the field is null."""
    t0 = time.time()
    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))
    duration = min(float(os.environ.get("STREAM_SECONDS", 10)),
                   max(budget - 120, 2.0))
    rate = float(os.environ.get("STREAM_EVENTS_PER_SEC", 1500))
    chunk_rows = int(os.environ.get("STREAM_CHUNK_ROWS", 1024))
    window_chunks = int(os.environ.get("STREAM_WINDOW_CHUNKS", 2))
    trees = int(os.environ.get("STREAM_TREES", 5))
    feats = int(os.environ.get("BENCH_FEATURES", 28))
    shard_events = int(os.environ.get("STREAM_SHARD_EVENTS",
                                      8 * chunk_rows))

    cfg = {"duration_s": duration, "events_per_sec": rate,
           "chunk_rows": chunk_rows, "window_chunks": window_chunks,
           "trees_per_refresh": trees, "features": feats}
    _stream_emit({"value": 0.0, "phase": "setup", **cfg})

    import shutil
    import tempfile

    from dmlc_core_tpu_torch.base.metrics import default_registry
    from dmlc_core_tpu_torch.io.recordio import encode_records
    from dmlc_core_tpu_torch.models import HistGBT
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.serve import ModelRegistry
    from dmlc_core_tpu_torch.stream import (ModelPublisher, OnlineTrainer,
                                            RecordIOTailer,
                                            encode_dense_events)

    dev, card = _bench_device(_stream_emit, cfg)
    stale_hist = default_registry().histogram(
        "stream_staleness_seconds",
        "event appended → servable prediction (an activated version "
        "has trained on it)",
        buckets=(0.25, 0.5, 1, 2, 4, 8, 16, 32, 64))

    rng = np.random.default_rng(13)

    def make_events(n, drift):
        X = rng.normal(size=(n, feats)).astype(np.float32)
        y = (X[:, 0] * X[:, 1] + (0.5 + drift) * X[:, 2]
             - drift * X[:, 3] > 0).astype(np.float32)
        return X, y

    root = tempfile.mkdtemp(prefix="bench_stream_")
    shard_dir = os.path.join(root, "events")
    os.makedirs(shard_dir)
    append_ts = []                    # wall clock per appended event seq
    stop_gen = threading.Event()

    def generator():
        """Paced appender: bursts every tick, flushed so the tailer sees
        bytes promptly; rotates shards so the tailer's growing-file-set
        path is exercised."""
        written = 0
        shard_idx = 0
        f = open(os.path.join(shard_dir, f"part-{shard_idx:04d}.rec"), "ab")
        start = time.perf_counter()
        try:
            while not stop_gen.is_set():
                target = int((time.perf_counter() - start) * rate)
                burst = min(target - written, 4096)
                if burst <= 0:
                    time.sleep(0.01)
                    continue
                drift = 0.2 * ((written // shard_events) % 3)
                X, y = make_events(burst, drift)
                blob = encode_records(encode_dense_events(X, y))
                f.write(blob)
                f.flush()
                now = time.time()
                append_ts.extend([now] * burst)
                written += burst
                if written // shard_events > shard_idx:
                    f.close()
                    shard_idx = written // shard_events
                    f = open(os.path.join(
                        shard_dir, f"part-{shard_idx:04d}.rec"), "ab")
        finally:
            f.close()

    Xh, yh = make_events(4096, drift=0.0)
    registry = ModelRegistry(max_batch=256, min_bucket=8, device=dev)
    publisher = ModelPublisher(registry, holdout=(Xh, yh),
                               name="stream-bench")
    model = HistGBT(n_trees=trees, max_depth=4, n_bins=32,
                    learning_rate=0.3, device=dev)
    tailer = RecordIOTailer(shard_dir,
                            cursor_uri=os.path.join(root, "cursor.ckpt"),
                            name="stream-bench")
    trainer = OnlineTrainer(model, tailer, n_features=feats,
                            chunk_rows=chunk_rows,
                            window_chunks=window_chunks, decay=1.0,
                            publisher=publisher, name="stream-bench")

    gen = threading.Thread(target=generator, daemon=True)
    gen.start()
    _stream_emit({"value": 0.0, "phase": "loop", **cfg})

    counters = ((H.hist_kernel, "launches"), (H.fused_round_kernel,
                "launches"), (H.descend_kernel, "launches"))
    before = [getattr(fn, a) for fn, a in counters]
    staleness = []
    served_floor = 0                  # events covered by an activation
    refreshes = []
    end = time.perf_counter() + duration
    try:
        while time.perf_counter() < end:
            left = end - time.perf_counter()
            r = trainer.refresh(timeout=max(min(left, 5.0), 0.1))
            if r is None:
                continue
            refreshes.append(r)
            if r.get("activated"):
                now = time.time()
                covered = min(r["records_total"], len(append_ts))
                for seq in range(served_floor, covered):
                    st = now - append_ts[seq]
                    staleness.append(st)
                    stale_hist.observe(st)
                served_floor = covered
    finally:
        stop_gen.set()
        gen.join(timeout=5.0)
        tailer.close()

    wall = time.time() - t0
    activated = sum(1 for r in refreshes if r.get("activated"))
    stale_sorted = sorted(staleness)

    def q(p):
        if not stale_sorted:
            return None
        return round(stale_sorted[min(len(stale_sorted) - 1,
                                      int(round(p * (len(stale_sorted)
                                                     - 1))))], 3)

    fit_s = [r["fit_seconds"] for r in refreshes]
    extra = {}
    if dev.type == "cuda":
        extra["kernel_launches"] = {
            name: getattr(fn, a) - b for name, (fn, a), b in zip(
                ("hist", "fused_round", "descend"), counters, before)}
    final = {
        "value": q(0.95) or 0.0,
        "phase": "done",
        "elapsed_s": round(wall, 1),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        **card,
        "staleness_seconds": {"p50": q(0.50), "p95": q(0.95),
                              "p99": q(0.99)},
        "refreshes_published": activated,
        "refreshes_total": len(refreshes),
        "rollbacks": publisher.rollbacks,
        "refreshes_per_sec": round(len(refreshes) / max(duration, 1e-9), 3),
        "refresh_rows_per_sec": round(
            sum(r["rows"] for r in refreshes) / max(duration, 1e-9), 1),
        "fit_seconds_mean": (round(sum(fit_s) / len(fit_s), 3)
                             if fit_s else None),
        "refresh_seconds_mean": (round(sum(
            r["refresh_seconds"] for r in refreshes) / len(refreshes), 3)
            if refreshes else None),
        "events_appended": len(append_ts),
        "events_consumed": tailer.records_seen,
        "events_served": served_floor,
        "trees_total": len(model.trees),
        "registry_versions": len(registry.versions()),
        "recompiles_steady_state": None,
        **extra,
        **cfg,
    }
    _stream_emit(final, final=True)
    shutil.rmtree(root, ignore_errors=True)


def _ps_bench() -> None:
    """``--ps``: web-scale sparse CTR over the sharded parameter server
    (the JAX bench's mode, field for field).

    In-process fleet (scheduler + ``PS_SERVERS`` (2) server threads) with
    ``PS_WORKERS`` (2) worker threads each running ``GBLinear.fit_ps``
    over its own synthetic hashing-space CTR stream — ``PS_FEATURES``
    (10M) feature cardinality, ``PS_ROWS`` (40,000) rows a worker of
    ``PS_NNZ`` (32) ids, minibatches of ``PS_BATCH_ROWS`` (2048) — so the
    weight vector exists only range-sharded on the fleet and each
    minibatch moves only its touched ids.  Headlines: **keys_per_sec**
    (sparse ids crossing the wire, push+pull directions) and
    **staleness_p95** (SSP lag observed at pull, in rounds — bounded by
    ``DMLC_PS_STALENESS``).  The parameter server is host numpy and
    sockets in both packages: no device work, so no device fields.  Each
    worker counts its shutdown at the scheduler (the JAX bench counts
    rank 0's alone, so its final join waits out its 30 s timeout; the
    record's ``elapsed_s`` leaves that wait out in both)."""
    t0 = time.time()
    features = int(os.environ.get("PS_FEATURES", 10_000_000))
    rows = int(os.environ.get("PS_ROWS", 40_000))
    nnz = int(os.environ.get("PS_NNZ", 32))
    batch_rows = int(os.environ.get("PS_BATCH_ROWS", 2048))
    nserver = int(os.environ.get("PS_SERVERS", 2))
    nworker = int(os.environ.get("PS_WORKERS", 2))

    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.models.linear import GBLinear
    from dmlc_core_tpu_torch.parallel.kvstore import DistAsyncKVStore
    from dmlc_core_tpu_torch.parallel.ps import (PSClient, PSScheduler,
                                                 PSServer)

    class _CTRStream:
        """Re-iterable synthetic sparse CTR pages (hashing space)."""

        def __init__(self, seed):
            self.seed = seed
            self.num_col = features

        def __iter__(self):
            rng = np.random.default_rng(self.seed)
            hot = rng.choice(features, 256, replace=False)
            w_true = rng.normal(size=256).astype(np.float32)
            page = 4 * batch_rows
            for lo in range(0, rows, page):
                n = min(page, rows - lo)
                idx = rng.integers(0, features, size=(n, nnz))
                # every row carries a few signal features
                idx[:, :4] = hot[rng.integers(0, 256, size=(n, 4))]
                vals = rng.normal(size=(n, nnz)).astype(np.float32)
                sig = np.searchsorted(np.sort(hot), idx[:, :4])
                m = (vals[:, :4] * w_true[np.argsort(hot)][sig]).sum(1)
                y = (m > 0).astype(np.float32)
                off = np.arange(0, n * nnz + 1, nnz, dtype=np.int64)
                yield RowBlock(offset=off, label=y,
                               index=idx.ravel().astype(np.int64),
                               value=vals.ravel())

    sched = PSScheduler("127.0.0.1", nworker=nworker, nserver=nserver)
    sched.start()
    servers = [PSServer("127.0.0.1", sched.port, server_id=i)
               for i in range(nserver)]
    for srv in servers:
        srv.start()
    sthreads = [threading.Thread(target=srv.serve_forever, daemon=True)
                for srv in servers]
    for st in sthreads:
        st.start()

    stats = {}

    def worker(rank):
        client = PSClient(root_uri="127.0.0.1", root_port=sched.port,
                          rank=rank)
        kv = DistAsyncKVStore(client, learning_rate=0.1)
        model = GBLinear(learning_rate=0.1, reg_lambda=0.0, device="cpu")
        model.fit_ps(_CTRStream(seed=rank), kv, num_col=features,
                     batch_rows=batch_rows, finalize=False)
        stats[rank] = {"keys": kv.stats["keys_synced"],
                       "staleness": list(kv.staleness_samples)}
        kv.close()      # every worker's shutdown, so the join ends now

    wthreads = [threading.Thread(target=worker, args=(r,))
                for r in range(nworker)]
    t_train = time.time()
    for wt in wthreads:
        wt.start()
    for wt in wthreads:
        wt.join()
    elapsed = time.time() - t_train
    for st in sthreads:
        st.join(timeout=30)
    sched.join(timeout=30)

    keys = sum(st["keys"] for st in stats.values())
    lags = np.array(sum((st["staleness"] for st in stats.values()), []),
                    np.float64)
    rec = {
        "bench": "ps_sparse_ctr", "provisional": False,
        "features": features, "rows_per_worker": rows, "nnz": nnz,
        "batch_rows": batch_rows, "servers": nserver, "workers": nworker,
        "elapsed_s": round(elapsed, 2),
        "rows_per_sec": round(nworker * rows / max(elapsed, 1e-9), 1),
        # each pushed id was pulled the same round: count both directions
        "keys_per_sec": round(2 * keys / max(elapsed, 1e-9), 1),
        "keys_moved": int(2 * keys),
        "staleness_p95": (float(np.percentile(lags, 95))
                          if len(lags) else None),
        "staleness_max": float(lags.max()) if len(lags) else None,
        "staleness_bound": int(os.environ.get("DMLC_PS_STALENESS", 4)),
        "pull_rounds": int(len(lags)),
        "wall_s": round(time.time() - t0, 2),
        "basis": "in-process fleet, single host: wire framing + server "
                 "aggregation are real, network hops are loopback",
    }
    _attach_metrics(rec)
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    modes = [a for a in sys.argv[1:] if a in _NOT_PORTED_MODES]
    if modes:
        sys.stderr.write(f"dmlc_core_tpu_torch.bench: {modes[0]} is not "
                         "ported (the flagship, --serve, --fleet, "
                         "--tenants, --stream and --ps modes only)\n")
        sys.exit(2)
    if "--serve" in sys.argv[1:]:
        _serve_bench()
    elif "--fleet" in sys.argv[1:]:
        _fleet_bench()
    elif "--tenants" in sys.argv[1:]:
        _tenants_bench()
    elif "--stream" in sys.argv[1:]:
        _stream_bench()
    elif "--ps" in sys.argv[1:]:
        _ps_bench()
    else:
        main()
