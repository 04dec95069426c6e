"""The sklearn-style surface: estimators, ``booster=`` and GridSearchCV.

    python -m dmlc_core_tpu_torch.examples.sklearn_pipeline [--device cpu] [--smoke]

The port of ``examples/sklearn_pipeline.py``: ``GBTClassifier`` with each
booster (``gbtree``, ``gblinear``) on 5,000 × 8 rows with string labels,
``GBTRegressor`` on a linear target, and — where scikit-learn imports —
``GridSearchCV`` over ``max_depth``.  ``--smoke`` fits 1,000 rows and a
fifth of the trees.
"""

from __future__ import annotations

import sys

import numpy as np

from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import GBTClassifier, GBTRegressor


def setup(smoke):
    """``(X, y, yr, n_fit, kw)``: rows, string labels, the regression
    target, the training rows and each estimator's parameters."""
    n, div = (1_000, 5) if smoke else (5_000, 1)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.where(X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0, "spam", "ham")
    yr = 2 * X[:, 0] - X[:, 1] + 0.1 * rng.normal(size=len(X))
    kw = {"classifier": dict(n_estimators=60 // div, max_depth=5),
          "regressor": dict(n_estimators=80 // div),
          "grid": dict(n_estimators=30 // div)}
    return X, y, yr, n * 4 // 5, kw


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    X, y, yr, n_fit, kw = setup(args.smoke)
    for booster in ("gbtree", "gblinear"):
        clf = GBTClassifier(booster=booster, device=args.device,
                            **kw["classifier"])
        clf.fit(X[:n_fit], y[:n_fit])
        print(f"{booster:9s} holdout accuracy "
              f"{clf.score(X[n_fit:], y[n_fit:]):.4f}")

    reg = GBTRegressor(device=args.device, **kw["regressor"])
    reg.fit(X[:n_fit], yr[:n_fit])
    print(f"regressor holdout R2    {reg.score(X[n_fit:], yr[n_fit:]):.4f}")

    try:
        from sklearn.model_selection import GridSearchCV
    except ImportError:
        print("(sklearn not installed - skipping GridSearchCV demo)")
        return
    half = len(X) * 2 // 5
    gs = GridSearchCV(GBTClassifier(device=args.device, **kw["grid"]),
                      {"max_depth": [3, 5]}, cv=2, scoring="accuracy")
    gs.fit(X[:half], y[:half])
    print(f"grid search best        {gs.best_params_} "
          f"(cv acc {gs.best_score_:.4f})")


if __name__ == "__main__":
    sys.exit(main())
