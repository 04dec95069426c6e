"""Closed-loop multi-process load generator for the fleet.

Traffic shape is deliberately hostile in the two ways real serving
traffic is:

* **heavy-tail request sizes** — rows per predict follow a capped
  Pareto (:func:`sample_size`): most requests are small, a fat tail
  lands near ``max_size``, so batch assembly sees the mix that makes
  power-of-two bucketing earn its keep;
* **diurnal QPS ramp** — the target rate follows a sinusoid
  (:func:`diurnal_qps`), so a run sweeps through under- and over-load
  instead of testing one operating point.

Each worker **process** (``python -m dmlc_core_tpu_torch.serve.fleet.loadgen
--worker cfg.json`` — a real process, so client-side CPU cannot be
the hidden bottleneck of the thing it measures) runs closed-loop
threads: issue one predict through
:class:`~dmlc_core_tpu_torch.serve.client.ResilientClient` (failover +
Retry-After honored), wait for the answer, verify it **bit-exactly**
against the expected predictions for whatever version answered, then
pace to the ramp.  Every request therefore ends in exactly one bucket:

* ``ok``     — answered, and bit-identical to ``expected[version]``;
* ``wrong``  — answered with anything else (the unforgivable bucket);
* ``dropped``— no answer after the client's whole retry budget.

``run_loadgen`` fans out the workers, merges their reports, and
returns fleet p50/p95/p99, per-version counts, and the drop/wrong
totals that the hot-swap acceptance gate (``dropped==0 and wrong==0``)
reads.  The expected predictions ride an ``.npz``: array ``X`` plus
one array ``v{version}`` per version the fleet may answer with.

**Multi-tenant mode** (``tenants=[...]``): each request first draws a
tenant from a bounded Zipf — P(tenant i) ∝ 1/(i+1)^``zipf_a`` over the
configured order, so the first tenant is hot and the tail is long, the
skew real multi-model fleets exhibit — and rides the
``X-Dmlc-Tenant`` header.  Expected arrays are then keyed
``{tenant}__v{version}``, reports gain a fourth bucket:

* ``shed`` — the router *deliberately* refused after the whole retry
  budget (terminal 429 quota/class shed or 503 saturation).  Admission
  control doing its job is not a drop; the tenancy drill gates the two
  buckets separately (bronze may shed, nobody may drop).

and the merged summary carries per-tenant counts and p50/95/99 so the
SLO scorecard can gate *each tenant's* tail latency, not the blend.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/fleet/loadgen.py``:
the same sampling (bit for bit: numpy's generators under the same
seeds), reports and buckets.  Its workers are HTTP clients and touch no
device, so their env carries no device setting (the JAX package's puts
``JAX_PLATFORMS=cpu`` there).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["sample_size", "diurnal_qps", "zipf_weights", "sample_tenant",
           "run_loadgen", "loadgen_worker"]


def sample_size(rng: np.random.Generator, alpha: float = 1.5,
                max_size: int = 32) -> int:
    """Heavy-tailed rows-per-request: capped Pareto(``alpha``) ≥ 1.
    Small ``alpha`` = fatter tail."""
    return int(min(max_size, max(1, math.floor(1.0 + rng.pareto(alpha)))))


def diurnal_qps(t_s: float, base_qps: float, amplitude: float = 0.5,
                period_s: float = 10.0) -> float:
    """Target rate at ``t_s`` seconds into the run: a sinusoidal
    day/night ramp around ``base_qps`` (peak = base×(1+amplitude)),
    floored at 10% of base so the loop never stalls.  Pure."""
    qps = base_qps * (1.0 + amplitude * math.sin(2.0 * math.pi * t_s
                                                / period_s))
    return max(0.1 * base_qps, qps)


def zipf_weights(n: int, a: float = 1.1) -> np.ndarray:
    """Cumulative bounded-Zipf weights over ``n`` ranks:
    P(i) ∝ 1/(i+1)^``a``.  Pure; feed to :func:`sample_tenant`."""
    CHECK(n >= 1, f"zipf over empty support (n={n})")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), a)
    return np.cumsum(w / w.sum())


def sample_tenant(rng: np.random.Generator, tenants: Sequence[str],
                  cum: np.ndarray) -> str:
    """Draw one tenant under the cumulative weights from
    :func:`zipf_weights` (index 0 = hottest)."""
    return tenants[int(np.searchsorted(cum, rng.random()))]


def _client_thread(cfg: Dict[str, Any], X: np.ndarray,
                   expected: Dict[Any, np.ndarray], seed: int,
                   out: List[Any]) -> None:
    from dmlc_core_tpu_torch.io.http_util import HttpError
    from dmlc_core_tpu_torch.serve.client import ResilientClient

    client = ResilientClient(cfg["endpoints"])
    rng = np.random.default_rng(seed)
    tenants = list(cfg.get("tenants") or [])
    cum = zipf_weights(len(tenants), cfg.get("zipf_a", 1.1)) \
        if tenants else None
    per_thread_qps = cfg["base_qps"] / (cfg["procs"] * cfg["threads"])
    t_start = time.monotonic()
    next_t = t_start
    while True:
        now = time.monotonic()
        if now - t_start >= cfg["duration_s"]:
            return
        tenant = sample_tenant(rng, tenants, cum) if tenants else None
        k = sample_size(rng, cfg["alpha"], cfg["max_size"])
        lo = int(rng.integers(0, len(X) - k + 1))
        t0 = time.monotonic()
        try:
            preds, version = client.predict(
                X[lo:lo + k], timeout_ms=cfg["timeout_ms"],
                tenant=tenant)
            lat = time.monotonic() - t0
            want = expected.get((tenant, int(version)))
            if want is not None and np.array_equal(
                    preds, want[lo:lo + k]):
                out.append(("ok", int(version), lat, tenant))
            else:
                out.append(("wrong", int(version), lat, tenant))
        except HttpError as e:  # noqa: PERF203 — terminal status
            lat = time.monotonic() - t0
            # a DELIBERATE refusal (quota/class 429, saturation 503)
            # that outlived the retry budget is admission control, not
            # data loss — the drill gates the buckets separately
            status = "shed" if e.status in (429, 503) else "dropped"
            out.append((status, -1, lat, tenant))
        except Exception:  # noqa: BLE001 — retry budget exhausted
            out.append(("dropped", -1, time.monotonic() - t0, tenant))
        # closed-loop pacing against the diurnal ramp: never issue
        # before the previous answer, sleep off any surplus
        rate = diurnal_qps(now - t_start, per_thread_qps,
                           cfg["amplitude"], cfg["period_s"])
        next_t = max(next_t + 1.0 / rate, time.monotonic())
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)


def loadgen_worker(cfg_path: str) -> int:
    """Worker-process entry: run the configured closed-loop threads and
    write the per-process report JSON."""
    import threading

    with open(cfg_path) as f:
        cfg = json.load(f)
    from dmlc_core_tpu_torch.base import metrics_agg as _agg
    _agg.install_spool("loadgen", int(cfg.get("seed", 0)))
    data = np.load(cfg["expected_npz"])
    X = np.asarray(data["X"], np.float32)
    # "v{n}" = untenanted; "{tenant}__v{n}" = that tenant's version n
    expected: Dict[Any, np.ndarray] = {}
    for k in data.files:
        if "__v" in k:
            tenant, _, ver = k.rpartition("__v")
            expected[(tenant, int(ver))] = np.asarray(data[k], np.float32)
        elif k.startswith("v"):
            expected[(None, int(k[1:]))] = np.asarray(data[k], np.float32)
    out: List[Any] = []
    threads = [threading.Thread(
        target=_client_thread,
        args=(cfg, X, expected, cfg["seed"] * 1000 + t, out))
        for t in range(cfg["threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=cfg["duration_s"] + 60)
    report: Dict[str, Any] = {
        "count": len(out),
        "ok": sum(1 for s, _, _, _ in out if s == "ok"),
        "dropped": sum(1 for s, _, _, _ in out if s == "dropped"),
        "wrong": sum(1 for s, _, _, _ in out if s == "wrong"),
        "shed": sum(1 for s, _, _, _ in out if s == "shed"),
        "by_version": {},
        "by_tenant": {},
        "lats_ms": [round(lat * 1000.0, 3) for s, _, lat, _ in out
                    if s == "ok"],
    }
    for s, v, lat, tenant in out:
        if s == "ok":
            key = str(v)
            report["by_version"][key] = report["by_version"].get(key, 0) + 1
        if tenant is not None:
            t_rep = report["by_tenant"].setdefault(
                tenant, {"count": 0, "ok": 0, "dropped": 0, "wrong": 0,
                         "shed": 0, "lats_ms": []})
            t_rep["count"] += 1
            t_rep[s] += 1
            if s == "ok":
                t_rep["lats_ms"].append(round(lat * 1000.0, 3))
    with open(cfg["out"], "w") as f:
        json.dump(report, f)
    return 0


def run_loadgen(endpoints: Union[str, Sequence[str]], expected_npz: str,
                duration_s: float = 5.0, procs: int = 2, threads: int = 4,
                base_qps: float = 200.0, amplitude: float = 0.5,
                period_s: float = 10.0, alpha: float = 1.5,
                max_size: int = 32, timeout_ms: int = 2000,
                seed: int = 0, workdir: Optional[str] = None,
                env: Optional[Dict[str, str]] = None,
                tenants: Optional[Sequence[str]] = None,
                zipf_a: float = 1.1) -> Dict[str, Any]:
    """Fan out ``procs`` worker processes against ``endpoints`` (one
    router URL or a replica URL list) and merge their reports into the
    fleet summary: ``{count, ok, dropped, wrong, shed, by_version,
    latency_p50/95/99_ms, throughput_rps}``.

    ``tenants`` switches on multi-tenant mode: requests draw a tenant
    from a bounded Zipf(``zipf_a``) over the given order (first =
    hottest) and the summary gains ``by_tenant`` — per-tenant
    count/ok/dropped/wrong/shed plus p50/95/99 — so a drill can gate
    each tenant's tail, not the blend."""
    CHECK(procs >= 1 and threads >= 1,
          f"need >=1 procs/threads, got {procs}/{threads}")
    import tempfile

    eps = [endpoints] if isinstance(endpoints, str) else list(endpoints)
    workdir = workdir or tempfile.mkdtemp(prefix="fleet_loadgen_")
    child_env = dict(os.environ)
    # `-m dmlc_core_tpu_torch...` resolves against the child's cwd — pin
    # the package root so workers import regardless of the caller's cwd
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    prior = child_env.get("PYTHONPATH", "")
    child_env["PYTHONPATH"] = \
        (pkg_root + os.pathsep + prior) if prior else pkg_root
    child_env.update(env or {})
    children = []
    t0 = time.monotonic()
    for p in range(procs):
        cfg = {"endpoints": eps, "expected_npz": expected_npz,
               "duration_s": duration_s, "procs": procs,
               "threads": threads, "base_qps": base_qps,
               "amplitude": amplitude, "period_s": period_s,
               "alpha": alpha, "max_size": max_size,
               "timeout_ms": timeout_ms, "seed": seed + p,
               "tenants": list(tenants) if tenants else None,
               "zipf_a": zipf_a,
               "out": os.path.join(workdir, f"loadgen_{p}.json")}
        cfg_path = os.path.join(workdir, f"loadgen_{p}.cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        children.append((cfg, subprocess.Popen(
            [sys.executable, "-m", "dmlc_core_tpu_torch.serve.fleet.loadgen",
             "--worker", cfg_path], env=child_env)))
    merged: Dict[str, Any] = {"count": 0, "ok": 0, "dropped": 0,
                              "wrong": 0, "shed": 0, "by_version": {},
                              "by_tenant": {}}
    lats: List[float] = []
    tenant_lats: Dict[str, List[float]] = {}
    try:
        for cfg, proc in children:
            rc = proc.wait(timeout=duration_s + 120)
            CHECK(rc == 0, f"loadgen worker exited rc={rc}")
            with open(cfg["out"]) as f:
                rep = json.load(f)
            for k in ("count", "ok", "dropped", "wrong", "shed"):
                merged[k] += rep[k]
            for v, n in rep["by_version"].items():
                merged["by_version"][v] = merged["by_version"].get(v, 0) + n
            for tenant, t_rep in rep.get("by_tenant", {}).items():
                m = merged["by_tenant"].setdefault(
                    tenant, {"count": 0, "ok": 0, "dropped": 0,
                             "wrong": 0, "shed": 0})
                for k in ("count", "ok", "dropped", "wrong", "shed"):
                    m[k] += t_rep[k]
                tenant_lats.setdefault(tenant, []).extend(t_rep["lats_ms"])
            lats.extend(rep["lats_ms"])
    finally:
        # a mid-loop CHECK failure must not strand the remaining workers
        for _cfg, proc in children:
            if proc.returncode is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
    wall = time.monotonic() - t0
    merged["wall_s"] = round(wall, 3)
    merged["throughput_rps"] = round(merged["ok"] / max(wall, 1e-9), 2)
    for q, key in ((50, "latency_p50_ms"), (95, "latency_p95_ms"),
                   (99, "latency_p99_ms")):
        merged[key] = (round(float(np.percentile(lats, q)), 3)
                       if lats else None)
    for tenant, t_lats in tenant_lats.items():
        for q, key in ((50, "latency_p50_ms"), (95, "latency_p95_ms"),
                       (99, "latency_p99_ms")):
            merged["by_tenant"][tenant][key] = (
                round(float(np.percentile(t_lats, q)), 3)
                if t_lats else None)
    return merged


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(loadgen_worker(sys.argv[2]))
    print("usage: python -m dmlc_core_tpu_torch.serve.fleet.loadgen "
          "--worker cfg.json", file=sys.stderr)
    sys.exit(2)
