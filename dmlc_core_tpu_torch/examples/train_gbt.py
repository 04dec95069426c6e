"""Train hist-GBT end to end: binning, boosting, early stopping, save/load.

    python -m dmlc_core_tpu_torch.examples.train_gbt [--device cpu] [--smoke]

The port of ``examples/train_gbt.py``: synthetic HIGGS-like data (200k ×
28, held-out 50k), 200 trees of depth 6 over 256 bins, ``subsample=0.8``,
AUC early stopping after 20 flat rounds, importances, and a save/load
round trip that must predict the same.  ``--smoke`` fits 4,000 rows and
8 trees.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import HistGBT


def make_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    return X, (margin > 0).astype(np.float32)


def setup(smoke):
    """``(X, y, Xv, yv, kw, fit_kw)``: the data, the model's parameters
    and ``fit``'s keywords."""
    n, nv, trees = (4_000, 1_000, 8) if smoke else (200_000, 50_000, 200)
    X, y = make_data(n, seed=7)
    Xv, yv = make_data(nv, seed=8)
    kw = dict(n_trees=trees, max_depth=6, n_bins=256, learning_rate=0.3,
              subsample=0.8, eval_metric="auc")
    return X, y, Xv, yv, kw, dict(eval_set=(Xv, yv), early_stopping_rounds=20)


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    X, y, Xv, yv, kw, fit_kw = setup(args.smoke)
    model = HistGBT(device=args.device, **kw)
    model.fit(X, y, **fit_kw)
    print(f"trained {len(model.trees)} trees in {model.last_fit_seconds:.1f}s "
          f"(best auc={model.best_score:.4f} @ iter {model.best_iteration})")

    acc = ((model.predict(Xv) > 0.5) == yv).mean()
    print(f"validation accuracy: {acc:.4f}")
    print(f"feature importances: {model.feature_importances()[:8]}...")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gbt_example.bin")
        model.save_model(path)
        again = HistGBT.load_model(path, device=args.device)
        assert (again.predict(Xv) == model.predict(Xv)).all()
    print("saved, reloaded, predictions identical")


if __name__ == "__main__":
    sys.exit(main())
