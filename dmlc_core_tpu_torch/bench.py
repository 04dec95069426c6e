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

Not in this module (the JAX bench's other modes): ``BENCH_CHIPS > 1`` and
its scaling probe, ``--serve``, ``--fleet``, ``--tenants``, ``--stream``,
``--ps``, ``--prodsim``, the kvstore smoke, the SLO scorecard
and jitcheck's ``recompiles_steady_state``.  The record leaves their
fields out, or writes null with a note.
"""

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
#: seconds of budget the infeed smoke needs left (the JAX bench's floor)
_INFEED_FLOOR_S = 75
_ROUND_S_PER_ROW = 6e-9

#: the JAX bench's modes this module does not have
_NOT_PORTED_MODES = ("--serve", "--fleet", "--tenants", "--stream", "--ps",
                     "--prodsim", "--scaling-probe")

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
    if deadline - time.time() < _INFEED_FLOOR_S:
        EV["notes"].append("infeed_stall_frac skipped: budget")
    else:
        try:
            EV["smoke"] = {**EV["smoke"], "infeed_stall_frac": {
                "value": _smoke_infeed(dev),
                "basis": "24 x [2048, 128] f32 batches through "
                         "DeviceFeed(depth=2), consumer sum(tanh(x @ w))"}}
        except Exception as e:  # noqa: BLE001
            EV["notes"].append(
                f"infeed_stall_frac failed: {type(e).__name__}: {e}"[:200])
    EV["notes"].append("scaling probe and kvstore smoke: not ported (null)")
    EV["phase"] = "done"
    emit(final=True)


if __name__ == "__main__":
    modes = [a for a in sys.argv[1:] if a in _NOT_PORTED_MODES]
    if modes:
        sys.stderr.write(f"dmlc_core_tpu_torch.bench: {modes[0]} is not "
                         "ported (the flagship mode only)\n")
        sys.exit(2)
    main()
