#!/usr/bin/env python3
"""Why serving from several threads of one process is slow.

    python3 -m dmlc_core_tpu_torch.tools.serve_threads [--seconds S]
        [--cpu-only] [--out PATH]

Runs the port bench's ``--tenants`` mode (``TENANTS_*`` at their defaults
but ``TENANTS_SECONDS``, from ``--seconds``) as child processes under
variants that tell apart the causes a lower rate from 4 threads than
from 1 can have: the interpreter lock handed between threads, the one
CUDA stream they share, the CUDA driver's per-context locking:

* ``gpu_t1`` / ``gpu_t4``: 1 and 4 threads on the card, as the bench runs;
* ``gpu_t4_streams``: 4 threads, each predict and page-in on a CUDA
  stream of its thread's own;
* ``gpu_t4_switch``: 4 threads, ``sys.setswitchinterval(0.0005)``
  (the default is 0.005 s);
* ``gpu_p4``: 4 processes of 1 thread at once, their load windows
  started together; its rate is their sum;
* ``gpu_t1_prof`` / ``gpu_t4_prof``: 1 and 4 threads under
  ``torch.profiler``: each CUDA runtime call's count and mean CPU time,
  the device's busy time and idle share (their rates are the
  profiler's, not comparable with the others);
* ``cpu_t1`` / ``cpu_t4`` / ``cpu_p4``: 1 and 4 threads, and 4
  processes of 1 thread, on the CPU (``BENCH_FORCE_CPU``) with one
  intra-op thread each, so that threads share only the interpreter lock.

Every child runs a probe thread for the load window: it sleeps 0.5 ms
and records how much later than that it runs again (the wait to retake
the interpreter lock), reported as p50 / p99 / mean in ms; and reads
``getrusage`` before and after the window: the process's voluntary and
involuntary context switches and its CPU seconds, each per request.
Prints one JSON line per variant (the bench's rate, requests, wrong
answers, the page-ins' mean wall, the probe, the profile) and one with
the card's name and power limit; ``--out`` also writes them all to a
JSON file.
``--cpu-only`` runs the CPU variants only (no card needed).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VARIANTS = {
    "gpu_t1": {"threads": 1},
    "gpu_t4": {"threads": 4},
    "gpu_t4_streams": {"threads": 4, "streams": True},
    "gpu_t4_switch": {"threads": 4, "switch_s": 0.0005},
    "gpu_p4": {"threads": 1, "procs": 4},
    "gpu_t1_prof": {"threads": 1, "profile": True},
    "gpu_t4_prof": {"threads": 4, "profile": True},
    "cpu_t1": {"threads": 1, "cpu": True},
    "cpu_t4": {"threads": 4, "cpu": True},
    "cpu_p4": {"threads": 1, "procs": 4, "cpu": True},
}
PROBE_SLEEP_S = 0.0005
# the CUDA runtime calls whose CPU time the profiled variants report
RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
                 "cudaStreamSynchronize", "cudaStreamWaitEvent",
                 "cudaEventRecord")


class GilProbe:
    """A thread that sleeps ``PROBE_SLEEP_S`` and records how late it
    runs again: the wait to retake the interpreter lock."""

    def __init__(self):
        self.lags = []
        self._ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(PROBE_SLEEP_S)
            self.lags.append(time.perf_counter() - t0 - PROBE_SLEEP_S)

    def start(self):
        self._thread.start()
        return self

    def stop(self, requests):
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self._stop.set()
        self._thread.join(timeout=5)
        n = max(requests, 1)
        out = {"voluntary_switches_per_request":
                   (ru.ru_nvcsw - self._ru0.ru_nvcsw) / n,
               "involuntary_switches_per_request":
                   (ru.ru_nivcsw - self._ru0.ru_nivcsw) / n,
               "cpu_seconds_per_request":
                   (ru.ru_utime + ru.ru_stime - self._ru0.ru_utime
                    - self._ru0.ru_stime) / n,
               "samples": len(self.lags)}
        s = sorted(self.lags)
        if s:
            out.update(lag_p50_ms=s[len(s) // 2] * 1e3,
                       lag_p99_ms=s[int(0.99 * (len(s) - 1))] * 1e3,
                       lag_mean_ms=sum(s) / len(s) * 1e3)
        return out


def per_thread_streams(torch):
    """Run each ``ModelRunner.predict`` and ``TenantRegistry.current``
    (a page-in) on a CUDA stream of the calling thread's own.  Each
    predict copies its answer back before it returns, so no stream
    still reads a model another thread pages out."""
    from dmlc_core_tpu_torch.serve.runner import ModelRunner
    from dmlc_core_tpu_torch.serve.tenancy.registry import TenantRegistry

    local = threading.local()

    def stream():
        s = getattr(local, "stream", None)
        if s is None:
            s = local.stream = torch.cuda.Stream()
        return s

    def on_stream(fn):
        def wrapped(*a, **k):
            with torch.cuda.stream(stream()):
                return fn(*a, **k)
        return wrapped

    ModelRunner.predict = on_stream(ModelRunner.predict)
    TenantRegistry.current = on_stream(TenantRegistry.current)


def profile_summary(torch, prof, wall_s):
    """CUDA runtime calls (count, mean CPU µs), the device events' time
    and the device's idle share over the load window (one stream: no
    overlap).  The runtime calls come from CUPTI, every thread's; the
    profiler records torch's CPU-side ops of the starting thread only,
    so none of the workers' are here."""
    rows = prof.key_averages()

    def dev_us(e):
        us = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if us is None else us

    runtime = {e.key: {"count": e.count,
                       "mean_cpu_us": e.self_cpu_time_total / max(e.count, 1)}
               for e in rows if e.key in RUNTIME_CALLS}
    device_us = sum(dev_us(e) for e in rows
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"runtime_calls": runtime,
            "device_ms": device_us / 1e3,
            "device_idle_share": (1.0 - device_us / 1e6 / wall_s
                                  if wall_s > 0 else None)}


def child(cfg) -> int:
    """One bench ``--tenants`` run under ``cfg``; prints the bench's
    lines, then one with the probe (and the profile)."""
    sys.path.insert(0, ROOT)
    import torch

    from dmlc_core_tpu_torch import bench

    if cfg.get("cpu"):
        torch.set_num_threads(1)
    if cfg.get("switch_s"):
        sys.setswitchinterval(cfg["switch_s"])
    if cfg.get("streams"):
        per_thread_streams(torch)
    state = {}
    emit = bench._tenants_emit

    def wrapped(rec, final=False):
        if rec.get("phase") == "load":
            barrier = cfg.get("barrier")
            if barrier:                # every process's window at once
                open(f"{barrier}.{os.getpid()}", "w").close()
                deadline = time.time() + 300
                while (len([f for f in os.listdir(os.path.dirname(barrier))
                            if f.startswith(os.path.basename(barrier) + ".")])
                       < cfg["procs"] and time.time() < deadline):
                    time.sleep(0.01)
            state["probe"] = GilProbe().start()
            if cfg.get("profile"):
                state["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                state["prof"].__enter__()
            state["t0"] = time.perf_counter()
        if rec.get("phase") == "done" and "probe" in state:
            wall = time.perf_counter() - state["t0"]
            out = {"probe": state["probe"].stop(rec["requests"])}
            if "prof" in state:
                state["prof"].__exit__(None, None, None)
                out["profile"] = profile_summary(torch, state["prof"],
                                                 wall)
            emit(rec, final)
            print(json.dumps(out), flush=True)
            return
        emit(rec, final)

    bench._tenants_emit = wrapped
    bench._tenants_bench()
    return 0


def run_variant(name, seconds, workdir):
    cfg = dict(VARIANTS[name])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "TENANTS_"))}
    env.update(TENANTS_THREADS=str(cfg["threads"]),
               TENANTS_SECONDS=str(seconds))
    if cfg.get("cpu"):
        env.update(BENCH_FORCE_CPU="1", OMP_NUM_THREADS="1")
    procs = cfg.get("procs", 1)
    if procs > 1:
        cfg["barrier"] = os.path.join(workdir, f"{name}.ready")
    children = [subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.serve_threads",
         "--child", json.dumps(cfg)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(procs)]
    recs, probes = [], []
    for p in children:
        out, err = p.communicate(timeout=600)
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        done = [r for r in lines if r.get("phase") == "done"]
        extra = [r for r in lines if "probe" in r]
        if p.returncode != 0 or not done or not extra:
            raise RuntimeError(f"{name}: child exited {p.returncode}: "
                               f"{err[-2000:]}")
        recs.append(done[-1])
        probes.append(extra[-1])
    res = {"variant": name, **{k: v for k, v in cfg.items()
                               if k != "barrier"},
           "value": sum(r["value"] for r in recs),
           "requests": sum(r["requests"] for r in recs),
           "wrong": sum(r["wrong"] for r in recs),
           "page_in_seconds_mean": [r.get("page_in_seconds_mean")
                                    for r in recs],
           "probe": [p["probe"] for p in probes]}
    if "profile" in probes[0]:
        res["profile"] = probes[0]["profile"]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--cpu-only", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(json.loads(args.child))
    import tempfile

    sys.path.insert(0, ROOT)
    names = [n for n in VARIANTS
             if not args.cpu_only or VARIANTS[n].get("cpu")]
    results = []
    card = None
    if not args.cpu_only:
        from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit
        card = gpu_name_and_power_limit()
    workdir = tempfile.mkdtemp(prefix="serve_threads_")
    for name in names:
        res = run_variant(name, args.seconds, workdir)
        results.append(res)
        print(json.dumps(res), flush=True)
    print(json.dumps({"card": card}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "variants": results}, f, indent=1)
    return 0 if all(r["wrong"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
