"""GBT training objectives (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/gbt_objectives.py``:
``binary:logistic``, ``multi:softmax`` (margins ``[n, K]``),
``reg:squarederror`` and the ranking objectives ``rank:pairwise``,
``rank:ndcg`` and ``rank:map`` (rows in fixed-size query blocks).  Every
objective provides ``grad_hess`` (the boosting step's inputs),
``transform`` (margin → prediction) and ``row_loss``/``metric``.
:data:`EVAL_METRICS` holds the validation metrics of the first three
(``logloss``, ``error``, ``auc``; ``mlogloss``, ``merror``; ``rmse``,
``mae``), each reduced in float64 and rounded to one f32 value, so that
the CPU and the GPU score alike.  The ranking objectives compute in
float64 and round once for the same reason.
"""

from __future__ import annotations

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal
from dmlc_core_tpu_torch.base.registry import Registry

__all__ = ["OBJECTIVES", "OBJECTIVE_NAMES", "EVAL_METRIC_NAMES",
           "EVAL_METRICS", "fold_scale_pos_weight"]

OBJECTIVES: Registry = Registry.get("gbt_objective")

#: every objective name the JAX package accepts (HistGBTParam's enum)
OBJECTIVE_NAMES = ("binary:logistic", "reg:squarederror", "multi:softmax",
                   "rank:pairwise", "rank:ndcg", "rank:map")
#: the JAX package's eval-metric names (HistGBTParam's enum)
EVAL_METRIC_NAMES = ("auc", "error", "logloss", "mae", "merror", "mlogloss",
                     "rmse")


def _sigmoid(pred: torch.Tensor) -> torch.Tensor:
    """f32 sigmoid computed in f64 and rounded once, so that the CPU and
    the GPU give the same bits (their f32 ``exp`` differ in the last
    place; two correctly-near f64 results almost never round apart)."""
    return torch.sigmoid(pred.double()).float()


class _ObjectiveBase:
    """Shared plumbing: the metric is the mean of per-row losses."""

    @classmethod
    def metric(cls, pred, y):
        return torch.mean(cls.row_loss(pred, y))

    @classmethod
    def eval_loss(cls, pred, y):
        """:meth:`metric` as a validation score: the mean in float64,
        rounded to f32 (one value on any device)."""
        return cls.row_loss(pred, y).double().mean().float()


@OBJECTIVES.register("binary:logistic")
class _Logistic(_ObjectiveBase):
    """grad/hess of log loss on raw margins; transform = sigmoid."""

    @staticmethod
    def grad_hess(pred, y):
        p = _sigmoid(pred)
        return p - y, p * (1.0 - p)

    @staticmethod
    def transform(pred):
        return _sigmoid(pred)

    @staticmethod
    def row_loss(pred, y):  # per-row logloss
        p = _sigmoid(pred)
        eps = 1e-7
        return -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))


def _softmax(pred: torch.Tensor) -> torch.Tensor:
    """Row softmax of ``[n, K]`` f32 margins computed in f64 and rounded
    once, as :func:`_sigmoid`: the CPU and the GPU give the same bits."""
    return torch.softmax(pred.double(), dim=1).float()


@OBJECTIVES.register("multi:softmax")
class _Softmax(_ObjectiveBase):
    """K-class softmax (XGBoost ``multi:softmax``): margins ``[n, K]``,
    grad/hess per class from the full softmax row; ``transform`` gives the
    argmax class, :meth:`prob` the probability matrix."""

    @staticmethod
    def grad_hess(pred, y):                  # pred [n, K], y [n] labels
        prob = _softmax(pred)
        yoh = torch.nn.functional.one_hot(y.to(torch.int64),
                                          pred.shape[1]).to(pred.dtype)
        return prob - yoh, torch.clamp(2.0 * prob * (1.0 - prob), min=1e-6)

    @staticmethod
    def transform(pred):                     # class index
        return torch.argmax(pred, dim=1).to(torch.float32)

    @staticmethod
    def prob(pred):
        return _softmax(pred)

    @staticmethod
    def row_loss(pred, y):                   # mlogloss
        logp = torch.log_softmax(pred.double(), dim=1)
        return -torch.gather(logp, 1, y.to(torch.int64)[:, None])[:, 0].float()


@OBJECTIVES.register("reg:squarederror")
class _SquaredError(_ObjectiveBase):
    @staticmethod
    def grad_hess(pred, y):
        return pred - y, torch.ones_like(pred)

    @staticmethod
    def transform(pred):
        return pred

    @staticmethod
    def row_loss(pred, y):  # per-row squared error
        return (pred - y) ** 2

    @classmethod
    def metric(cls, pred, y):  # rmse = sqrt of the mean row loss
        return torch.sqrt(torch.mean(cls.row_loss(pred, y)))

    @classmethod
    def eval_loss(cls, pred, y):
        return torch.sqrt(cls.row_loss(pred, y).double().mean()).float()


@OBJECTIVES.register("rank:pairwise")
class _PairwiseRank(_ObjectiveBase):
    """RankNet-style pairwise ranking over ``qid`` groups (XGBoost
    ``rank:pairwise``).

    Rows arrive grouped and padded (:meth:`HistGBT._regroup_ranking`):
    every query occupies ``group_size`` consecutive rows, pad docs carry
    ``y = −1`` and weight 0, and each rank's rows are whole queries, so
    the pairwise gradients are rank-local.

    Per better-pair (i, j), rel_i > rel_j in one query: ``λ = σ(s_j −
    s_i)``; ``∂L/∂s_i −= λ``, ``∂L/∂s_j += λ``, and both docs add the
    hessian ``λ(1−λ)``.  Queries go in blocks of ``block_queries``, so
    the ``[QB, G, G]`` pair tensors stay a bounded transient.

    Everything is computed in float64 (the margin differences are exact
    there) and g/h are rounded to f32 once: the CPU and the GPU give the
    same bits, where f32 sums over pairs would round apart.  Rank
    positions come from stable sorts on both devices."""

    def __init__(self, group_size: int, block_queries: int = 256):
        self.G = int(group_size)
        self.QB = int(block_queries)

    def _map_blocks(self, pred, y, block_fn):
        """``block_fn(S, better, sb, rb)`` over ``[QB, G]`` blocks of the
        ``[Q, G]`` queries (float64): ``S[i, j] = s_i − s_j``, the
        better-pair mask, the scores and relevances.  Returns the list
        of per-block results and ``Q``."""
        G = self.G
        Q = pred.shape[0] // G
        s = pred.reshape(Q, G).double()
        r = y.reshape(Q, G).double()
        outs = []
        for lo in range(0, Q, max(self.QB, 1)):
            sb, rb = s[lo:lo + self.QB], r[lo:lo + self.QB]
            vb = rb >= 0
            S = sb[:, :, None] - sb[:, None, :]             # s_i − s_j
            better = ((rb[:, :, None] > rb[:, None, :])
                      & vb[:, :, None] & vb[:, None, :])
            outs.append(block_fn(S, better, sb, rb))
        return outs, Q

    def _pair_weight(self, sb, rb, better):
        """Per-pair lambda weight ``[QB, G, G]`` or None (RankNet)."""
        return None

    def grad_hess(self, pred, y):
        def block_fn(S, better, sb, rb):
            lam = torch.where(better, torch.sigmoid(-S), 0.0)
            rho = lam * (1.0 - lam)
            w = self._pair_weight(sb, rb, better)
            if w is not None:
                lam = lam * w
                rho = rho * w
            g = -lam.sum(dim=2) + lam.sum(dim=1)            # winner/loser
            h = rho.sum(dim=2) + rho.sum(dim=1)
            return g, h

        outs, _ = self._map_blocks(pred, y, block_fn)
        if not outs:
            z = torch.zeros(0, dtype=torch.float32, device=pred.device)
            return z, z
        g = torch.cat([o[0] for o in outs]).reshape(-1).float()
        h = torch.cat([o[1] for o in outs]).reshape(-1).float()
        # docs with no pairs have h = 0: XGBoost's tiny floor
        return g, torch.clamp(h, min=1e-16)

    @staticmethod
    def transform(pred):
        return pred

    def row_loss(self, pred, y):
        log_fatal("rank objectives have no per-row loss; use metric()")

    def metric(self, pred, y):
        """Mean pairwise logistic loss over all better-pairs."""
        def block_fn(S, better, sb, rb):
            return (torch.where(better, torch.nn.functional.softplus(-S),
                                0.0).sum(), better.sum())

        outs, _ = self._map_blocks(pred, y, block_fn)
        loss = sum((o[0] for o in outs), torch.zeros((), dtype=torch.float64,
                                                     device=pred.device))
        count = sum(int(o[1]) for o in outs)
        return (loss / max(count, 1)).float()


def _stable_ranks(keyed):
    """Each doc's position when ``keyed`` sorts ascending, ties in doc
    order (``argsort(argsort(·))`` with stable sorts, as ``jnp.argsort``)."""
    order = torch.argsort(keyed, dim=-1, stable=True)
    return order, torch.argsort(order, dim=-1, stable=True)


@OBJECTIVES.register("rank:ndcg")
class _NDCGRank(_PairwiseRank):
    """LambdaMART over NDCG (XGBoost ``rank:ndcg``): each better-pair's
    lambda is weighted by |ΔNDCG| of swapping the two docs in the
    current ranking (exp2 gain, log2 discount over the full group).
    Pads (rel −1) rank last and carry no gain; a query with IDCG 0 has
    no better-pairs to weight."""

    def _pair_weight(self, sb, rb, better):
        vb = rb >= 0
        G = sb.shape[-1]
        keyed = torch.where(vb, -sb, float("inf"))
        ranks = _stable_ranks(keyed)[1]
        disc = 1.0 / torch.log2(2.0 + ranks.to(sb.dtype))   # [QB, G]
        gain = torch.where(vb, torch.exp2(rb) - 1.0, 0.0)
        rel_best = torch.sort(rb, dim=-1, descending=True).values
        igain = torch.where(rel_best >= 0, torch.exp2(rel_best) - 1.0, 0.0)
        pos_disc = 1.0 / torch.log2(
            2.0 + torch.arange(G, dtype=sb.dtype, device=sb.device))
        idcg = (igain * pos_disc[None, :]).sum(dim=-1)      # [QB]
        inv_idcg = torch.where(idcg > 0.0, 1.0 / idcg, 0.0)
        # swapping i and j: |ΔDCG| = |g_i − g_j| · |d_i − d_j|
        return ((gain[:, :, None] - gain[:, None, :]).abs()
                * (disc[:, :, None] - disc[:, None, :]).abs()
                * inv_idcg[:, None, None])


@OBJECTIVES.register("rank:map")
class _MAPRank(_PairwiseRank):
    """LambdaMART over MAP (XGBoost ``rank:map``, rel > 0 relevant):
    lambdas weighted by |ΔAP| of swapping the pair in the current
    ranking, the JAX package's closed form (positions a < b in score
    order, prefix counts ``c_p``, ``T_p = Σ_{q≤p} rel_q/(q+1)``, swap
    shift ``s = rel_b − rel_a``):

        R·ΔAP = (rel_b·(c_a + s) − rel_a·c_a)/(a+1)
              + (rel_a − rel_b)·c_b/(b+1)
              + s·(T_{b−1} − T_a)
    """

    def _pair_weight(self, sb, rb, better):
        vb = rb >= 0
        G = sb.shape[-1]
        f64 = sb.dtype
        rel = torch.where(vb, (rb > 0.0).to(f64), 0.0)      # [QB, G]
        keyed = torch.where(vb, -sb, float("inf"))
        order, ranks = _stable_ranks(keyed)
        rel_sorted = torch.gather(rel, -1, order)
        invp = 1.0 / torch.arange(1, G + 1, dtype=f64, device=sb.device)
        c = torch.cumsum(rel_sorted, dim=-1)                # c_p (incl.)
        T = torch.cumsum(rel_sorted * invp, dim=-1)         # T_p
        R = c[:, -1]
        inv_R = torch.where(R > 0.0, 1.0 / R, 0.0)
        C = torch.gather(c, -1, ranks)                      # at each doc
        Td = torch.gather(T, -1, ranks)
        P = (ranks + 1).to(f64)                             # 1-based
        i_first = ranks[:, :, None] < ranks[:, None, :]

        def pick(x):                                        # (a, b)
            xi, xj = x[:, :, None], x[:, None, :]
            return (torch.where(i_first, xi, xj),
                    torch.where(i_first, xj, xi))

        rel_a, rel_b = pick(rel)
        C_a, C_b = pick(C)
        T_a, T_b = pick(Td)
        P_a, P_b = pick(P)
        s = rel_b - rel_a
        T_bm1 = T_b - rel_b / P_b
        delta = ((rel_b * (C_a + s) - rel_a * C_a) / P_a
                 + (rel_a - rel_b) * C_b / P_b
                 + s * (T_bm1 - T_a))
        return delta.abs() * inv_R[:, None, None]


def _metric_auc(margin, y):
    """ROC-AUC by the rank-sum identity with MIDRANKS for ties (a tree's
    margins tie heavily), 0.5 on a single-class set — the JAX package's
    ``_metric_auc``, its sums taken in float64 (exact on half-integer
    ranks), rounded to f32."""
    s = torch.sort(margin).values
    lo = torch.searchsorted(s, margin, right=False)
    hi = torch.searchsorted(s, margin, right=True)
    midrank = (lo + hi + 1).double() / 2.0          # 1-based midranks
    yd = y.double()
    npos = yd.sum()
    nneg = y.shape[0] - npos
    denom = npos * nneg
    auc = ((midrank * yd).sum() - npos * (npos + 1) / 2) / torch.where(
        denom > 0, denom, 1.0)
    return torch.where(denom > 0, auc, 0.5).float()


def _metric_error(margin, y):
    return ((_sigmoid(margin) > 0.5) != (y > 0.5)).double().mean().float()


def _metric_mae(margin, y):
    return (margin - y).abs().double().mean().float()


def _metric_merror(margin, y):
    return (torch.argmax(margin, dim=1) != y.to(torch.int64)
            ).double().mean().float()


#: eval_metric name → (fn(margin, y) -> f32 scalar tensor, maximize?)
EVAL_METRICS = {
    "logloss": (_Logistic.eval_loss, False),
    "error": (_metric_error, False),
    "auc": (_metric_auc, True),
    "rmse": (_SquaredError.eval_loss, False),
    "mae": (_metric_mae, False),
    "mlogloss": (_Softmax.eval_loss, False),
    "merror": (_metric_merror, False),
}

#: which metrics fit which objective's margins (the JAX package's table)
_METRICS_BY_OBJECTIVE = {
    "binary:logistic": {"logloss", "error", "auc"},
    "reg:squarederror": {"rmse", "mae"},
    "multi:softmax": {"mlogloss", "merror"},
    "rank:pairwise": set(),
    "rank:ndcg": set(),
    "rank:map": set(),
}


def fold_scale_pos_weight(param, y, weight):
    """Fold ``param.scale_pos_weight`` into the instance-weight vector
    (XGBoost: positives' grad AND hess scale by the factor — an instance
    weight).  Numpy in, numpy out, as in the JAX package."""
    if param.scale_pos_weight == 1.0:
        return weight
    CHECK(param.objective == "binary:logistic",
          f"scale_pos_weight only applies to binary:logistic "
          f"(objective is {param.objective!r})")
    spw = np.where(np.asarray(y) == 1.0,
                   np.float32(param.scale_pos_weight), np.float32(1.0))
    return spw if weight is None else np.asarray(weight, np.float32) * spw
