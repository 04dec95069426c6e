"""``GBLinear`` at out-of-core scale: the Criteo-shaped page cache through
``GBLinear.fit_iter``.

    BENCH_GBLIN_ROWS=50000000 python -m dmlc_core_tpu_torch.tools.bench_gblinear
    BENCH_GBLIN_DTYPE=float32  # the f32 comparison run

The port's counterpart of the repository's ``scripts/bench_gblinear.py``,
with its knobs, defaults and JSON fields: ``BENCH_GBLIN_ROWS`` (50M) ×
``BENCH_GBLIN_FEATURES`` (39) rows of ``cpp/gen_libsvm.cc``'s rule (seed 7;
the text shared with ``tools/bench_external.py`` under ``BENCH_EXT_DIR``),
``BENCH_GBLIN_ROUNDS`` (50) rounds of ``binary:logistic`` after 3 warmup
rounds, ``feature_dtype`` ``BENCH_GBLIN_DTYPE`` (bfloat16).  ``fit_iter``
densifies the CSR pages into bounded slabs that go up through
``DeviceFeed`` into the device matrix, allocated once: the dense matrix
never exists on the host.  One JSON line: assembly (stream and upload)
seconds, rounds/s with the chunk evidence, the host's peak RSS.  It runs
on the card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from dmlc_core_tpu_torch.tools.bench_external import (WORKDIR, card_fields,
                                                      criteo_svm, rss_gb)

ROWS = int(os.environ.get("BENCH_GBLIN_ROWS", 50_000_000))
FEATS = int(os.environ.get("BENCH_GBLIN_FEATURES", 39))
ROUNDS = int(os.environ.get("BENCH_GBLIN_ROUNDS", 50))
DTYPE = os.environ.get("BENCH_GBLIN_DTYPE", "bfloat16")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from dmlc_core_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)          # raises without a GPU
    out = {"rows": ROWS, "features": FEATS, "rounds": ROUNDS,
           "feature_dtype": DTYPE}
    svm, cache, gen_s = criteo_svm(ROWS, FEATS, WORKDIR)
    if gen_s is not None:
        out["gen_seconds"] = gen_s

    from dmlc_core_tpu_torch.bench import chunk_stats
    from dmlc_core_tpu_torch.data.iter import RowBlockIter
    from dmlc_core_tpu_torch.models.linear import GBLinear

    t0 = time.perf_counter()
    it = RowBlockIter.create(f"{svm}#{cache}", 0, 1, "libsvm")
    out["open_or_parse_seconds"] = round(time.perf_counter() - t0, 1)

    m = GBLinear(n_rounds=ROUNDS, objective="binary:logistic",
                 feature_dtype=DTYPE, device=dev)
    t0 = time.perf_counter()
    m.fit_iter(it, num_col=FEATS, warmup_rounds=3)
    total = time.perf_counter() - t0
    it.close()

    assembly = total - m.last_warmup_seconds - m.last_fit_seconds
    matrix_gb = ROWS * FEATS * (2 if DTYPE == "bfloat16" else 4) / 1e9
    out.update({
        "total_seconds": round(total, 1),
        "assembly_seconds": round(assembly, 1),
        "matrix_gb_on_device": round(matrix_gb, 2),
        "assembly_mb_per_sec": round(matrix_gb * 1e3 / max(assembly, 1e-9),
                                     1),
        "warmup_seconds": round(m.last_warmup_seconds, 1),
        "boost_seconds": round(m.last_fit_seconds, 2),
        "rounds_per_sec": round(ROUNDS / m.last_fit_seconds, 2),
        "peak_rss_gb": round(rss_gb(), 2),
        "weight_norm": round(float((m.weights ** 2).sum() ** 0.5), 4),
        "bias": round(m.bias, 5),
    })
    out.update(chunk_stats(m.last_chunk_times, ROUNDS, m.last_fit_seconds))
    out.update(card_fields(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
