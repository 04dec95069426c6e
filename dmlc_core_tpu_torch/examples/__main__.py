"""Run every example, each in a child process with a 300 s limit.

    python -m dmlc_core_tpu_torch.examples [--device cpu] [--smoke]
        [--jobs N] [NAME ...]

The counterpart of ``scripts/run_examples.sh``: each example (all of
them, or the ``NAME``s given) runs as ``python -m
dmlc_core_tpu_torch.examples.<name>`` with ``--device`` (and ``--smoke``)
passed through, ``--jobs`` of them at a time (1 by default); its last two
lines are printed as it ends, or its last 20 when it fails.  The last
line is one JSON object, ``{"examples": [{"name", "rc", "seconds",
"last"}, ...]}`` in the examples' order.  Exit 0 only when every example
exited 0.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

EXAMPLES = ("distributed_local", "elastic_recovery", "external_memory_gbt",
            "fm_libfm", "rank_pairwise", "resnet_recordio", "serve_gbt",
            "sklearn_pipeline", "sparse_highdim_gbt", "stream_gbt",
            "train_gbt")
TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_one(name, device, smoke):
    """``(rc, seconds, output)`` of one example; rc None when it was
    killed at the time limit."""
    cmd = [sys.executable, "-m", f"dmlc_core_tpu_torch.examples.{name}",
           "--device", device] + (["--smoke"] if smoke else [])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            # the example and every process it started (one session)
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = None
        log.seek(0)
        out = log.read()
    return rc, time.perf_counter() - t0, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("names", nargs="*", metavar="NAME",
                   help=f"examples to run (default: all of {EXAMPLES})")
    args = p.parse_args(argv)
    unknown = sorted(set(args.names) - set(EXAMPLES))
    if unknown:
        p.error(f"unknown examples {unknown}")
    lock = threading.Lock()

    def one(name):
        rc, seconds, out = run_one(name, args.device, args.smoke)
        lines = [ln for ln in out.splitlines() if ln.strip()]
        with lock:
            print(f"== {name} ==")
            if rc != 0:
                print(f"EXAMPLE FAILED: {name} (exit {rc}, None: killed at "
                      f"{TIMEOUT_S} s)")
                print("\n".join(lines[-20:]))
            else:
                print("\n".join(lines[-2:]))
            print(f"   {seconds:.1f} s", flush=True)
        return {"name": name, "rc": rc, "seconds": seconds,
                "last": lines[-1] if lines else ""}

    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        results = list(pool.map(one, args.names or EXAMPLES))
    print(json.dumps({"examples": results}), flush=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
