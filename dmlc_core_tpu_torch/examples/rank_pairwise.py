"""Learning to rank with hist-GBT: ``rank:pairwise`` over qid groups.

    python -m dmlc_core_tpu_torch.examples.rank_pairwise [--device cpu] [--smoke]

The port of ``examples/rank_pairwise.py``: 2,000 synthetic queries of 8
to 40 documents whose relevance follows a hidden nonlinear score, 120
trees of depth 5 over 64 bins fitted with ``fit(qid=)``, scored on 200
further queries by ``models.ranking`` (NDCG@10, MAP@10, pairwise
accuracy).  ``--smoke`` fits 100 queries and 10 trees.
"""

from __future__ import annotations

import sys

import numpy as np

from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import HistGBT
from dmlc_core_tpu_torch.models.ranking import (mean_average_precision, ndcg,
                                                pairwise_accuracy)


def make_queries(n_queries, seed, F=6):
    """Docs whose true relevance follows a hidden nonlinear score."""
    rng = np.random.default_rng(seed)
    rng_w = np.random.default_rng(42)      # same scorer for train/test
    wtrue = rng_w.normal(size=F)
    Xs, ys, qids = [], [], []
    for q in range(n_queries):
        nd = int(rng.integers(8, 40))
        X = rng.normal(size=(nd, F)).astype(np.float32)
        s = X @ wtrue + 0.5 * X[:, 0] * X[:, 1]
        rel = np.zeros(nd, np.float32)
        top = np.argsort(s)
        rel[top[-3:]] = 1.0
        rel[top[-1]] = 2.0
        Xs.append(X)
        ys.append(rel)
        qids.append(np.full(nd, q, np.int64))
    return np.concatenate(Xs), np.concatenate(ys), np.concatenate(qids)


def setup(smoke):
    """``(X, y, qid, Xt, yt, qt, kw)``."""
    nq, trees = (100, 10) if smoke else (2000, 120)
    X, y, qid = make_queries(nq, seed=7)
    Xt, yt, qt = make_queries(200, seed=8)
    kw = dict(n_trees=trees, max_depth=5, n_bins=64,
              objective="rank:pairwise", learning_rate=0.2)
    return X, y, qid, Xt, yt, qt, kw


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    X, y, qid, Xt, yt, qt, kw = setup(args.smoke)
    model = HistGBT(device=args.device, **kw)
    model.fit(X, y, qid=qid)

    scores = model.predict(Xt)
    print(f"test ndcg@10           {ndcg(yt, scores, qt, k=10):.4f}")
    print(f"test map@10            "
          f"{mean_average_precision(yt, scores, qt, k=10):.4f}")
    print(f"test pairwise accuracy {pairwise_accuracy(yt, scores, qt):.4f}")
    print("(chance pairwise accuracy = 0.5)")


if __name__ == "__main__":
    sys.exit(main())
