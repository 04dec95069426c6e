#!/usr/bin/env python3
"""Drive the PyTorch port (``dmlc_core_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

The quickest proof that the port starts on the GPU and that its CUDA
kernels are right.  Phases, each printing one JSON line; any failure raises
and the script exits non-zero without the final ``ok`` line:

1. device — the card's name and power limit, torch/CUDA versions, and the
   build of every kernel from ``dmlc_core_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, all started together);
2. kernels — each kernel at the main path's shapes (10M rows, 28 features,
   256 bins: ``hist`` at the root, ``fused_round`` at n_prev 1..16) against
   its plain PyTorch version on the same inputs (bit-identical), twice on
   the same inputs (identical bytes), timed with CUDA events (median of
   ``REPS``) beside its bound and, where one PyTorch call computes the
   same function, that call;
3. main path — ``HistGBT(n_trees=5, max_depth=6, n_bins=256).fit`` on
   HIGGS-like data (bench.py's rule, seed 7), launch counts read around the
   fit, train logloss falling every round, ``predict`` on held-out rows,
   ``save_model`` → ``load_model`` giving the same predictions, and the
   round's bin-matrix bound from ``bins_bytes_per_round``;
4. cross-device — the same fit on a 100k-row slice on the GPU and on the
   CPU (plain versions): tree 0 bit-identical, every tree's split
   structure identical, predictions allclose;
5. deep kernels — the checks of phase 2 for ``fused_round`` at the levels
   of deeper trees (n_prev 32, 64 and 2048, up to ``max_depth=12``),
   where the histogram outgrows shared memory and the kernel adds
   straight into the global one;
6. the ``kernels`` line, then the card's name and power limit, then the
   ``ok`` line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

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


def time_ms(torch, fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
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
                      rates):
    """``fused_round`` at one level (``n_prev`` parents) against its
    plain version, twice over, in both split-table forms; then timed."""
    F, n = bins.shape
    B = N_BINS
    dev = bins.device
    nd = torch.randint(0, n_prev, (n,), dtype=torch.int32, device=dev,
                       generator=gen)
    nd = torch.where(masked, -1, nd).to(torch.int32)
    feat = torch.randint(0, F, (n_prev,), dtype=torch.int32, device=dev,
                         generator=gen)
    thr = torch.randint(0, B - 1, (n_prev,), dtype=torch.int32,
                        device=dev, generator=gen)
    prev = H.hist_kernel(bins, nd, g, h, n_prev, B, kg, kh)
    require(torch.equal(prev, H.hist_plain(bins, nd, g, h, n_prev, B, kg,
                                           kh)),
            f"hist kernel != hist_plain (n_nodes={n_prev})")
    a = H.fused_round_kernel(bins, nd, feat, thr, g, h, prev, n_prev, B,
                             kg, kh, True)
    b = H.fused_round_kernel(bins, nd, feat, thr, g, h, prev, n_prev, B,
                             kg, kh, True)
    c = H.fused_round_plain(bins, nd, feat, thr, g, h, prev, n_prev, B,
                            kg, kh, True)
    torch.cuda.synchronize()
    require(torch.equal(a[0], c[0]), f"fused_round new_node != plain "
            f"(n_prev={n_prev})")
    require(torch.equal(a[1], c[1]), f"fused_round hist != plain "
            f"(n_prev={n_prev})")
    require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            f"fused_round not reproducible (n_prev={n_prev})")
    # per-row split arrays (the JAX signature) give the same result
    safe = nd.clamp(min=0).long()
    r = H.fused_round_kernel(bins, nd, feat[safe], thr[safe], g, h, prev,
                             n_prev, B, kg, kh, False)
    require(torch.equal(r[0], a[0]) and torch.equal(r[1], a[1]),
            f"fused_round per-row form differs (n_prev={n_prev})")
    nbytes = (F * n + 4 * n + 8 * n + 2 * n_prev * F * B * 4
              + 8 * n_prev + 4 * n + 2 * 2 * n_prev * F * B * 4)
    b_ms, b_by = bound(nbytes, 2 * F * n, rates)
    return {
        "n_prev": n_prev,
        "ms": time_ms(torch, lambda: H.fused_round_kernel(
            bins, nd, feat, thr, g, h, prev, n_prev, B, kg, kh, True), REPS),
        "plain_ms": time_ms(torch, lambda: H.fused_round_plain(
            bins, nd, feat, thr, g, h, prev, n_prev, B, kg, kh, True),
            max(3, REPS // 3)),
        "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": max(max_abs_err(torch, a[1], c[1]),
                           max_abs_err(torch, a[0], c[0])),
        "bytes": nbytes}


def kernel_inputs(torch, H):
    """The kernel checks' inputs, made on the card from ``SEED``: bins,
    logistic g/h, a 1% mask of rows (node −1), the fixed-point scales and
    the generator for the split tables."""
    dev = torch.device("cuda")
    n, F, B = ROWS, FEATURES, N_BINS
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bins = torch.randint(0, B, (F, n), dtype=torch.uint8, device=dev,
                         generator=gen)
    margin = 0.5 * torch.randn(n, device=dev, generator=gen)
    p = torch.sigmoid(margin)
    y = (torch.rand(n, device=dev, generator=gen) < p).float()
    g, h = p - y, p * (1 - p)
    masked = torch.rand(n, device=dev, generator=gen) < 0.01
    kg, kh = H.hist_scales(g, h)
    return bins, g, h, masked, gen, kg, kh


def phase_kernels(torch, H, rates):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    n, F, B = ROWS, FEATURES, N_BINS
    bins, g, h, masked, gen, kg, kh = kernel_inputs(torch, H)
    out = {}

    # -- hist at the root --------------------------------------------------
    node = torch.where(masked, -1, 0).to(torch.int32)
    k1 = H.hist_kernel(bins, node, g, h, 1, B, kg, kh)
    k2 = H.hist_kernel(bins, node, g, h, 1, B, kg, kh)
    pl = H.hist_plain(bins, node, g, h, 1, B, kg, kh)
    torch.cuda.synchronize()
    require(torch.equal(k1, pl), "hist kernel != hist_plain")
    require(torch.equal(k1, k2), "hist kernel not reproducible run to run")
    require(bool(torch.isfinite(k1).all()), "hist not finite")
    # the one-call library yardstick: index_add_ over a precomputed flat
    # (plane, feature, bin) index (index build left out of the timing)
    valid = ~masked
    idx = (torch.arange(F, device=dev)[:, None] * B + bins.long())
    idx = torch.cat([idx.reshape(-1), idx.reshape(-1) + F * B])
    vals = torch.cat([torch.where(valid, g, 0.0).expand(F, n).reshape(-1),
                      torch.where(valid, h, 0.0).expand(F, n).reshape(-1)])
    lib_out = torch.zeros(2 * F * B, device=dev)

    def lib_call():
        lib_out.zero_()
        lib_out.index_add_(0, idx, vals)

    lib_call()
    torch.cuda.synchronize()
    # f32 atomics over ~4e4 rows per cell: agree to ~1e-6 of the largest
    lib_err = float((lib_out.reshape(2, 1, F, B) - k1).abs().max()
                    / k1.abs().max())
    require(lib_err < 1e-3, f"index_add_ yardstick disagrees ({lib_err})")
    t_lib = time_ms(torch, lib_call, REPS)
    del idx, vals
    nbytes = F * n + 4 * n + 8 * n + 2 * F * B * 4
    b_ms, b_by = bound(nbytes, 2 * F * n, rates)
    out["hist"] = {
        "ms": time_ms(torch, lambda: H.hist_kernel(bins, node, g, h, 1, B,
                                                   kg, kh), REPS),
        "plain_ms": time_ms(torch, lambda: H.hist_plain(bins, node, g, h, 1,
                                                        B, kg, kh),
                            max(3, REPS // 3)),
        "library_ms": t_lib, "library_rel_err": lib_err, "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": max_abs_err(torch, k1, pl),
        "bytes": nbytes}
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
    mean = {k: statistics.fmean(c[k] for c in cases)
            for k in ("ms", "plain_ms", "bound_ms")}
    by = {c["bound_by"] for c in cases}
    out["fused_round"] = {**mean, "library_ms": None,
                          "bound_by": by.pop() if len(by) == 1 else "mixed",
                          "max_abs_err": max(c["max_abs_err"] for c in cases)}
    return out


def phase_deep_kernels(torch, H, rates):
    """``fused_round`` at the levels of deeper trees, where the histogram
    outgrows shared memory and the kernel adds into the global one.  Run
    after the main path: run before it, they slow the fit's first tree
    by 10–30 ms (PERF.md)."""
    bins, g, h, masked, gen, kg, kh = kernel_inputs(torch, H)
    for n_prev in DEEP_N_PREV:
        case = check_fused_round(torch, H, bins, g, h, masked, gen, n_prev,
                                 kg, kh, rates)
        emit({"phase": "kernel", "name": "fused_round", "n": ROWS,
              "F": FEATURES, "B": N_BINS, "beyond_main_path": True, **case})


def higgs_like(np, n, F, seed):
    """bench.py's HIGGS-like rule: dense gaussians, a nonlinear label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    return X, (margin > 0).astype(np.float32)


def phase_main(torch, np, H, rates):
    from dmlc_core_tpu_torch import HistGBT
    from dmlc_core_tpu_torch.models.histgbt import _predict_trees
    from dmlc_core_tpu_torch.ops.quantile import apply_bins

    t0 = time.perf_counter()
    X, y = higgs_like(np, ROWS, FEATURES, 7)
    Xv, yv = higgs_like(np, 100_000, FEATURES, 8)
    datagen_s = time.perf_counter() - t0
    model = HistGBT(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    H.hist_kernel.launches = 0
    H.fused_round_kernel.launches = 0
    t0 = time.perf_counter()
    model.fit(X, y)
    wall_s = time.perf_counter() - t0
    launches = {"hist": H.hist_kernel.launches,
                "fused_round": H.fused_round_kernel.launches}
    require(launches["hist"] == TREES,
            f"hist launched {launches['hist']} times, want {TREES}")
    want = (MAX_DEPTH - 1) * TREES
    require(launches["fused_round"] == want,
            f"fused_round launched {launches['fused_round']} times, want "
            f"{want}")
    # train logloss after each round, from the trees' margins
    bins_t = apply_bins(torch.from_numpy(X).cuda(), model.cuts)
    y_d = torch.from_numpy(y).cuda()
    stacked = model._stacked_trees(model.trees)
    margin = torch.zeros(ROWS, device="cuda")
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
    require(acc > 0.6, f"held-out accuracy {acc} too low")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.bin")
        model.save_model(path)
        again = HistGBT.load_model(path)
        require(np.array_equal(again.predict(Xv), pv),
                "load_model predictions differ")
    # a round streams the [F, n] bin matrix once per level (fused) at the
    # least: the floor of a round's time on this card's HBM
    round_bytes = H.bins_bytes_per_round(MAX_DEPTH, ROWS, FEATURES,
                                         fused=True)
    steady_s = (model.last_tree_times[-1] - model.last_tree_times[0]) / (
        TREES - 1)
    emit({"phase": "main", "rows": ROWS, "features": FEATURES,
          "trees": TREES, "max_depth": MAX_DEPTH, "n_bins": N_BINS,
          "fit_seconds": model.last_fit_seconds,
          "rounds_per_sec": TREES / model.last_fit_seconds,
          # trees 2.. only: the first tree also pays each torch kernel's
          # first launch on the card
          "steady_rounds_per_sec": 1.0 / steady_s,
          "round_bin_bytes": round_bytes,
          "round_bound_ms": round_bytes / rates[0] * 1e3,
          "hist_builds_per_round": H.leaves_built_per_round(MAX_DEPTH),
          "tree_times": model.last_tree_times,
          "bin_seconds": model.last_bin_seconds, "fit_wall_seconds": wall_s,
          "datagen_seconds": datagen_s, "train_logloss": losses,
          "holdout_accuracy": acc, "launches": launches})
    return launches, X[:100_000], y[:100_000]


def phase_cross_device(np, X, y):
    from dmlc_core_tpu_torch import HistGBT

    kw = dict(n_trees=TREES, max_depth=MAX_DEPTH, n_bins=N_BINS)
    gpu = HistGBT(device="cuda", **kw).fit(X, y)
    cpu = HistGBT(device="cpu", **kw).fit(X, y)
    require(np.array_equal(gpu.cuts.cpu().numpy().view(np.uint32),
                           cpu.cuts.numpy().view(np.uint32)),
            "cuts differ between cuda and cpu")
    for key in ("feat", "thr", "gain", "leaf"):
        require(gpu.trees[0][key].tobytes() == cpu.trees[0][key].tobytes(),
                f"tree 0 {key} differs between cuda and cpu")
    for i, (a, b) in enumerate(zip(gpu.trees, cpu.trees)):
        require(np.array_equal(a["feat"], b["feat"])
                and np.array_equal(a["thr"], b["thr"]),
                f"tree {i} split structure differs between cuda and cpu")
    pg, pc = gpu.predict(X), cpu.predict(X)
    require(np.allclose(pg, pc, rtol=1e-5, atol=1e-6),
            "cuda and cpu predictions differ")
    emit({"phase": "cross_device", "rows": len(X), "trees": TREES,
          "max_abs_pred_diff": float(np.abs(pg - pc).max()),
          "identical_trees": sum(
              all(a[k].tobytes() == b[k].tobytes() for k in a)
              for a, b in zip(gpu.trees, cpu.trees))})


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.ops import histogram as H
    from dmlc_core_tpu_torch.utils import device as device_mod

    t_start = time.perf_counter()
    smi = phase_device(torch, device_mod, _build)
    rates = card_rates(torch.cuda.get_device_name(0))
    kernels = phase_kernels(torch, H, rates)
    launches, Xs, ys = phase_main(torch, np, H, rates)
    phase_cross_device(np, Xs, ys)
    del Xs, ys
    phase_deep_kernels(torch, H, rates)
    src = "dmlc_core_tpu_torch/ops/csrc/histogram.cu"
    replaces = {"hist": "dmlc_core_tpu/ops/histogram.py:369",
                "fused_round": "dmlc_core_tpu/ops/histogram.py:531"}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         "held_against_plain": True}
        for name, k in kernels.items()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
