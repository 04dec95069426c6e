"""Ranking evaluation metrics over qid groups (host-side numpy).

Companions to the ``rank:pairwise`` objective (models/histgbt.py): the
in-training eval reports pairwise loss because the EVAL_METRICS
``(margin, y)`` signature cannot see group structure; these helpers
score predictions per query after the fact, XGBoost-eval-style
(``ndcg@k``, ``map@k``).  Reference context: SURVEY.md §2a ``data.h ::
Row::qid`` — the field exists in the reference's data plane precisely
for these consumers.

This package's own copy of ``dmlc_core_tpu.models.ranking`` (host numpy,
held to the JAX package's ``tests/test_ranking.py`` cases).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK_EQ

__all__ = ["ndcg", "mean_average_precision", "pairwise_accuracy"]


def _group_slices(qid: np.ndarray):
    order = np.argsort(qid, kind="stable")
    qs = qid[order]
    starts = np.flatnonzero(np.r_[True, qs[1:] != qs[:-1]])
    ends = np.r_[starts[1:], len(qs)]
    for s, e in zip(starts, ends):
        yield order[s:e]


def ndcg(y: np.ndarray, scores: np.ndarray, qid: np.ndarray,
         k: Optional[int] = None) -> float:
    """Mean NDCG@k over queries (gain = 2^rel − 1, log2 discount).

    Queries whose ideal DCG is 0 (all relevance 0) score 1.0, matching
    XGBoost's convention of not penalizing unjudgeable queries."""
    CHECK_EQ(len(y), len(scores), "y/scores length mismatch")
    CHECK_EQ(len(y), len(qid), "y/qid length mismatch")
    vals = []
    for rows in _group_slices(np.asarray(qid)):
        rel = np.asarray(y, np.float64)[rows]
        sc = np.asarray(scores, np.float64)[rows]
        kk = len(rows) if k is None else min(k, len(rows))
        top = np.argsort(-sc, kind="stable")[:kk]
        disc = 1.0 / np.log2(np.arange(2, kk + 2))
        dcg = ((2.0 ** rel[top] - 1.0) * disc).sum()
        ideal = np.sort(rel)[::-1][:kk]
        idcg = ((2.0 ** ideal - 1.0) * disc).sum()
        vals.append(1.0 if idcg == 0 else dcg / idcg)
    return float(np.mean(vals)) if vals else 0.0


def mean_average_precision(y: np.ndarray, scores: np.ndarray,
                           qid: np.ndarray,
                           k: Optional[int] = None) -> float:
    """MAP@k with binary relevance (y > 0 counts as relevant)."""
    vals = []
    for rows in _group_slices(np.asarray(qid)):
        rel = (np.asarray(y, np.float64)[rows] > 0).astype(np.float64)
        sc = np.asarray(scores, np.float64)[rows]
        kk = len(rows) if k is None else min(k, len(rows))
        top = np.argsort(-sc, kind="stable")[:kk]
        hits = rel[top]
        if hits.sum() == 0:
            vals.append(0.0)
            continue
        prec_at = np.cumsum(hits) / np.arange(1, kk + 1)
        vals.append(float((prec_at * hits).sum() / hits.sum()))
    return float(np.mean(vals)) if vals else 0.0


def pairwise_accuracy(y: np.ndarray, scores: np.ndarray,
                      qid: np.ndarray) -> float:
    """Fraction of within-query better-pairs the scores order correctly
    (the quantity rank:pairwise directly optimizes)."""
    good = total = 0
    for rows in _group_slices(np.asarray(qid)):
        rel = np.asarray(y, np.float64)[rows]
        sc = np.asarray(scores, np.float64)[rows]
        better = rel[:, None] > rel[None, :]
        correct = sc[:, None] > sc[None, :]
        good += int((better & correct).sum())
        total += int(better.sum())
    return good / total if total else 0.0
