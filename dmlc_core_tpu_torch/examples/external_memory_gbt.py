"""Out-of-core boosting: LibSVM file → parse → disk-paged cache →
``fit_external`` → ``predict_iter``.

    python -m dmlc_core_tpu_torch.examples.external_memory_gbt [--device cpu] [--smoke]

The port of ``examples/external_memory_gbt.py``: 50,000 sparse rows of 16
features (half of each row present) written as LibSVM text, read through
``RowBlockIter`` over a ``#cache`` file (parse once, page through the
cache), 30 trees of depth 5 over 64 bins by ``fit_external``, and
streamed predictions over the same pages.  ``--smoke`` writes 3,000 rows
and fits 5 trees.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from dmlc_core_tpu_torch.data.iter import RowBlockIter
from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import HistGBT

F = 16


def write_svm(path, n):
    """Writes ``n`` LibSVM rows of ``F`` features (half present); returns
    the dense rows (absent entries as they were drawn) and the labels."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(np.int32)
    with open(path, "w") as f:
        for i in range(n):
            cols = rng.choice(F, size=F // 2, replace=False)  # sparse rows
            feats = " ".join(f"{j}:{X[i, j]:.4f}" for j in sorted(cols))
            f.write(f"{y[i]} {feats}\n")
    return X, y


def setup(smoke):
    """``(n, kw, fit_kw)``: the rows, the model's and ``fit_external``'s
    parameters."""
    n, trees = (3_000, 5) if smoke else (50_000, 30)
    return n, dict(n_trees=trees, max_depth=5, n_bins=64,
                   learning_rate=0.3), dict(num_col=F, eval_every=10)


def fit(tmp, device, smoke):
    """The example's fit in ``tmp``: ``(model, labels, train acc)``."""
    n, kw, fit_kw = setup(smoke)
    svm = os.path.join(tmp, "train.svm")
    _, y = write_svm(svm, n)
    # '#cache' suffix: parse once, page through a cache file
    it = RowBlockIter.create(f"{svm}#{tmp}/cache.bin", 0, 1, "libsvm")
    try:
        model = HistGBT(device=device, **kw)
        # small datasets run the in-core cached engine, big ones stream
        # fixed-shape chunks a level (DMLC_TPU_EXTERNAL_DEVICE_BUDGET)
        model.fit_external(it, **fit_kw)
        print(f"out-of-core trained {len(model.trees)} trees "
              f"({model.last_external_route} route)")
        # scoring streams too: the dense matrix never exists on the host
        preds = model.predict_iter(it)
    finally:
        it.close()
    acc = float(((preds > 0.5) == y).mean())
    print(f"streamed predictions over {len(preds)} rows, train acc {acc:.3f}")
    return model, y, acc


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    with tempfile.TemporaryDirectory() as tmp:
        fit(tmp, args.device, args.smoke)


if __name__ == "__main__":
    sys.exit(main())
