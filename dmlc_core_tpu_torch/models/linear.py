"""GBLinear — the linear booster (XGBoost ``booster=gblinear``), PyTorch
port.

The counterpart of ``dmlc_core_tpu/models/linear.py``: each boosting
round applies XGBoost's *parallel (shotgun-style) damped coordinate
update* to every feature at once,

    delta_j = lr * ( -(Σ_i g_i·x_ij + λ·w_j) / (Σ_i h_i·x_ij² + λ) )

with an elastic-net soft-threshold for the L1 term (``alpha``), a
coordinate whose denominator vanishes (an all-zero column at λ = 0)
left where it is, and the bias step ``b − lr·Σg / (Σh + 1e-6)``.

A round is torch array code on the model's device (the JAX package's
round is XLA array code too, no Pallas kernel): over row blocks of
``_BLOCK_ROWS`` rows, ``margin = X_b @ w + b``, the objective's g/h
(``gbt_objectives.OBJECTIVES``, shared with ``HistGBT``), then
``Σ g·x_j`` as ``g @ X_b`` and ``Σ h·x_j²`` as ``h @ (X_b·X_b)``.  The
block bounds the temporaries: JAX's ``(h[:, None]·x·x).sum(0)`` is one
fused XLA reduction that streams X once, where eager torch would hold two
``[n, F]`` f32 temporaries beside X (2 × 7.8 GB at 50M × 39); here at
most two ``[_BLOCK_ROWS, F]`` f32 blocks exist at a time.  With
``feature_dtype="bfloat16"`` X is stored as ``torch.bfloat16`` (rounded
to nearest even on the way up, the bits of ``ml_dtypes``' cast) and each
block is upcast to f32 before its products, as JAX promotes
``bf16 @ f32``.

Data parallel (``mesh=``, the port's ``parallel.mesh`` world, one process
per GPU): every rank passes the global rows and keeps
``shard_row_ranges(n, world)[rank]``; the round's one collective is an
``all_reduce`` of ``[gsum (F), hsum (F), Σg, Σh]`` (JAX's ``psum``).

Rounds run in chunks of ``min(n_rounds, 25)`` with a remainder chunk; each
chunk ends with one fetch, whose arrival time is recorded in
``last_chunk_times`` (the JAX package's chunk-boundary evidence).  The
JAX package caches one compiled program per chunk length
(``_ROUNDS_FN_CACHE``); eager torch compiles nothing, so there is no
program cache, and ``warmup_rounds > 0`` runs one discarded round (the
first use of every torch op) where JAX compiles both chunk programs.

``fit_ps`` is sparse SGD over a dist_async KVStore (``parallel/ps``):
JAX's host arithmetic over CSR minibatches, line for line, so one worker
against one server writes the JAX package's weights bit for bit; the
finalized weights are the model's (host) weight vector, which
``predict`` uploads to the model's device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.data.device_feed import DeviceFeed
from dmlc_core_tpu_torch.models.gbt_objectives import (OBJECTIVES, _sigmoid,
                                                       fold_scale_pos_weight)
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import Mesh, local_mesh
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["GBLinear", "GBLinearParam"]

#: rows a round's products take at a time: bounds the f32 temporaries
#: (the upcast block and its square) to 2 × 4 · _BLOCK_ROWS · F bytes
_BLOCK_ROWS = 1 << 20
#: rows ``fit`` sends up at a time (f32 slabs through ``DeviceFeed``)
_UPLOAD_ROWS = 2_000_000
#: rounds a dispatch chunk (the JAX package's K)
_CHUNK = 25
#: rows per predict batch on the device
_PREDICT_BATCH = 2_000_000


class GBLinearParam(Parameter):
    """Hyperparameters (XGBoost gblinear names where they exist)."""

    n_rounds = field(int, default=100, lower_bound=1)
    learning_rate = field(float, default=0.5, lower_bound=0.0,
                          description="damping of the parallel "
                                      "coordinate step (eta)")
    reg_lambda = field(float, default=1.0, lower_bound=0.0,
                       description="L2 on weights")
    reg_alpha = field(float, default=0.0, lower_bound=0.0,
                      description="L1 on weights (soft-threshold)")
    scale_pos_weight = field(float, default=1.0, lower_bound=0.0,
                             description="binary:logistic — weight "
                                         "multiplier for positive rows "
                                         "(imbalanced data)")
    objective = field(str, default="binary:logistic",
                      enum=["binary:logistic", "reg:squarederror"])
    base_score = field(float, default=0.0)
    feature_dtype = field(str, default="float32",
                          enum=["float32", "bfloat16"],
                          description="device dtype of X: bfloat16 "
                                      "halves H2D bytes and device "
                                      "residency (7.8→3.9 GB at "
                                      "50M×39)")
    # no seed field: the parallel coordinate rounds are deterministic


class GBLinear:
    """Boosted linear model on one device per process.

    ``device`` is ``"cuda"`` (the default; raises without a GPU) or
    ``"cpu"``; ``mesh`` is the data axis (default: the process group's,
    size 1 without one)."""

    _MODEL_MAGIC = b"DMLCTPU.GBLIN.v1\n"

    def __init__(self, param: Optional[GBLinearParam] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None, **kwargs: Any):
        self.param = param or GBLinearParam()
        if kwargs:
            self.param.init(kwargs)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh()
        self._obj = OBJECTIVES[self.param.objective]
        self.weights: Optional[np.ndarray] = None    # [F]
        self.bias: float = 0.0
        self.last_fit_seconds: Optional[float] = None
        self.last_warmup_seconds: Optional[float] = None
        #: (rounds done, seconds since the loop began) at each chunk's fetch
        self.last_chunk_times: List[Tuple[int, float]] = []

    # -- training -------------------------------------------------------
    def _x_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.param.feature_dtype == "bfloat16"
                else torch.float32)

    def _upload(self, n: int, F: int, slabs) -> torch.Tensor:
        """This rank's rows ``[lo, hi)`` of ``n`` global rows as a device
        matrix of the feature dtype, filled from ``(global_row, slab)``
        f32 slabs (in row order) into a buffer allocated once.  The
        slabs go up through :class:`~dmlc_core_tpu_torch.data.device_feed.
        DeviceFeed` (pinned, on a side stream, one ahead), and each lands
        in its rows with a cast on the device (round to nearest even for
        bf16), so neither the host nor the device ever holds a second
        full copy: at most three f32 slabs exist on the device, the one
        being cast, the one in flight and one awaiting reuse."""
        lo, hi = self.mesh.row_range(n)
        x_d = torch.zeros((hi - lo, F), dtype=self._x_dtype(),
                          device=self.device)

        def mine():
            for start, slab in slabs:
                a, b = max(start, lo), min(start + len(slab), hi)
                if a < b:
                    yield slab[a - start:b - start]

        at = 0
        with DeviceFeed(mine(), self.device, depth=1,
                        host_prefetch=2) as feed:
            # next() without iter(): iter() rewinds, and a one-pass
            # source cannot
            for slab in iter(lambda: next(feed, None), None):
                x_d[at:at + len(slab)].copy_(slab)
                at += len(slab)
        return x_d

    def fit(self, X: np.ndarray, y: np.ndarray,
            weight: Optional[np.ndarray] = None,
            warmup_rounds: int = 0) -> "GBLinear":
        """Train on dense ``X [n, F]`` (every rank the global rows), sent
        up ``_UPLOAD_ROWS`` rows at a time."""
        X = np.asarray(X, np.float32)
        y = np.ascontiguousarray(y, np.float32)
        n, F = X.shape
        CHECK_EQ(len(y), n, "X/y row mismatch")
        weight = fold_scale_pos_weight(self.param, y, weight)
        mask = (np.ones(n, np.float32) if weight is None
                else np.ascontiguousarray(weight, np.float32))
        x_d = self._upload(n, F, ((lo, X[lo:lo + _UPLOAD_ROWS])
                                  for lo in range(0, n, _UPLOAD_ROWS)))
        return self._fit_device(x_d, y, mask, warmup_rounds)

    def _round(self, x_d: torch.Tensor, y_d: torch.Tensor,
               w_d: torch.Tensor, wv: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One damped parallel coordinate round (JAX ``one_round``)."""
        p = self.param
        F = x_d.shape[1]
        acc = torch.zeros(2 * F + 2, dtype=torch.float32, device=self.device)
        for lo in range(0, x_d.shape[0], _BLOCK_ROWS):
            xb = x_d[lo:lo + _BLOCK_ROWS].float()   # a view when f32
            g, h = self._obj.grad_hess(xb @ wv + b, y_d[lo:lo + _BLOCK_ROWS])
            wb = w_d[lo:lo + _BLOCK_ROWS]
            g = g * wb
            h = h * wb
            acc[:F] += g @ xb                         # Σ g·x_j
            acc[F:2 * F] += h @ (xb * xb)             # Σ h·x_j²
            acc[2 * F] += g.sum()
            acc[2 * F + 1] += h.sum()
        coll.device_allreduce(acc, self.mesh)       # JAX's four psums
        gsum, hsum = acc[:F], acc[F:2 * F]
        gb, hb = acc[2 * F], acc[2 * F + 1]
        lam, alpha, lr = p.reg_lambda, p.reg_alpha, p.learning_rate
        # per coordinate: min_d ½·denom·d² + grad_j·d + α(|wv+d| − |wv|),
        # closed form soft_threshold(denom·wv − grad_j, α) / denom
        grad_j = gsum + lam * wv
        denom = hsum + lam
        alive = denom > 1e-10          # a dead coordinate stays put
        safe = torch.where(alive, denom, torch.ones_like(denom))
        raw = denom * wv - grad_j
        if alpha > 0.0:
            target = (torch.sign(raw)
                      * torch.clamp(torch.abs(raw) - alpha, min=0.0) / safe)
        else:
            target = raw / safe
        target = torch.where(alive, target, wv)
        return wv + lr * (target - wv), b - lr * gb / (hb + 1e-6)

    def _fit_device(self, x_d: torch.Tensor, y: np.ndarray,
                    mask: np.ndarray, warmup_rounds: int) -> "GBLinear":
        """Shared training body over this rank's device rows ``x_d`` and
        the global labels and row weights."""
        p = self.param
        n = len(y)
        lo, hi = self.mesh.row_range(n)
        y_d = torch.from_numpy(y[lo:hi].copy()).to(self.device)
        w_d = torch.from_numpy(mask[lo:hi].copy()).to(self.device)
        F = x_d.shape[1]
        K = min(p.n_rounds, _CHUNK)
        wv = torch.zeros(F, dtype=torch.float32, device=self.device)
        b = torch.tensor(p.base_score, dtype=torch.float32,
                         device=self.device)
        t_w = get_time()
        if warmup_rounds > 0:
            warm = self._round(x_d, y_d, w_d, wv, b)
            warm[0][:1].cpu()
        self.last_warmup_seconds = get_time() - t_w

        t0 = get_time()
        self.last_chunk_times = []
        done = 0
        while done < p.n_rounds:
            for _ in range(min(K, p.n_rounds - done)):
                wv, b = self._round(x_d, y_d, w_d, wv, b)
                done += 1
            wv[:1].cpu()                 # chunk boundary evidence
            self.last_chunk_times.append((done, get_time() - t0))
        self.weights = wv.cpu().numpy()
        self.bias = float(b.cpu())
        self.last_fit_seconds = get_time() - t0
        return self

    def fit_iter(self, row_iter, num_col: Optional[int] = None,
                 warmup_rounds: int = 0,
                 rows_per_upload: int = 2_000_000) -> "GBLinear":
        """Train over a :class:`~dmlc_core_tpu_torch.data.iter.RowBlockIter`
        (LibSVM/LibFM pages).  Pages densify into ``rows_per_upload``-row
        slabs (``iter_dense_slabs``) that go up through ``DeviceFeed``
        into the device matrix, allocated once: the full dense
        matrix never exists on the host.  The rounds are :meth:`fit`'s.
        Every rank reads the whole iterator and keeps its rows."""
        from dmlc_core_tpu_torch.data.iter import iter_dense_slabs

        F = max(num_col or 0, row_iter.num_col)
        CHECK(F > 0, "fit_iter: no columns (num_col unset and the "
                     "iterator reports width 0)")
        n = row_iter.num_rows
        counted = False
        if n is None:
            # a counting pass: the fill pass relies on the RowBlockIter
            # rewind contract (iterating again restarts from the top)
            counted = True
            n = sum(b.size for b in row_iter)
        CHECK(n > 0, "fit_iter: iterator yielded no rows")
        R = max(1, min(rows_per_upload, n))
        y = np.zeros(n, np.float32)
        w = np.zeros(n, np.float32)
        seen = [0]

        def slabs():
            for xs, ys, ws in iter_dense_slabs(row_iter, F, R):
                lo, rows = seen[0], len(ys)
                CHECK(lo + rows <= n,
                      "fit_iter: iterator row count inconsistent")
                y[lo:lo + rows] = ys
                w[lo:lo + rows] = fold_scale_pos_weight(self.param, ys, ws)
                yield lo, xs.copy()        # xs is a view of a reused buffer
                seen[0] = lo + rows

        x_d = self._upload(n, F, slabs())
        CHECK(not (counted and seen[0] == 0),
              "fit_iter: iterator yielded rows in the counting pass but "
              "none in the fill pass — it is not re-iterable (RowBlockIter "
              "contract: iteration must rewind); pass num_col/num_rows or "
              "use a rewindable iterator")
        CHECK_EQ(seen[0], n, "fit_iter: iterator row count inconsistent")
        return self._fit_device(x_d, y, w, warmup_rounds)

    def fit_ps(self, row_iter, kv, num_col: Optional[int] = None,
               batch_rows: int = 8192, n_epochs: int = 1,
               name: str = "gblinear", finalize: bool = True
               ) -> "GBLinear":
        """Web-scale sparse SGD over a parameter server (the JAX
        package's ``fit_ps``).

        Weights live range-sharded on the PS fleet behind ``kv`` (a
        dist_async :class:`~dmlc_core_tpu_torch.parallel.kvstore.
        DistAsyncKVStore`); each CSR minibatch pulls only the feature ids
        it touches, computes the mean-loss gradient on the host straight
        off the ``offset``/``index``/``value`` arrays, and pushes it back
        asynchronously — the server applies SGD with the store's
        learning_rate on arrival.  One ``tick`` per minibatch is the SSP
        round.  ``reg_lambda`` is applied lazily (touched coordinates
        only), scaled 1/n with the data term.

        ``finalize`` pulls the full weight vector into ``self.weights`` /
        ``self.bias`` so :meth:`predict` (on the model's device) works;
        pass False at true 10M+ scale and serve from the fleet instead.
        """
        from dmlc_core_tpu_torch.data.iter import iter_csr_minibatches

        p = self.param
        F = max(num_col or 0, getattr(row_iter, "num_col", 0) or 0)
        CHECK(F > 0, "fit_ps: no columns (num_col unset and the "
                     "iterator reports width 0)")
        # bias rides at id F: one PS array, one pull per minibatch
        kv.init_sparse(name, n_keys=F + 1)
        logistic = p.objective == "binary:logistic"
        lam = p.reg_lambda
        t0 = get_time()
        for _ in range(int(n_epochs)):
            for blk in iter_csr_minibatches(row_iter, batch_rows):
                n = blk.size
                vals = (blk.value if blk.value is not None
                        else np.ones(blk.nnz, np.float32))
                uids, inv = np.unique(blk.index, return_inverse=True)
                ids = np.concatenate([uids, [F]])
                w = np.asarray(kv.pull_sparse(name, ids), np.float32)
                rows = np.repeat(np.arange(n),
                                 np.diff(blk.offset)).astype(np.int64)
                margin = np.full(n, w[-1] + p.base_score, np.float32)
                np.add.at(margin, rows, w[:-1][inv] * vals)
                y = blk.label
                if logistic:
                    g = 1.0 / (1.0 + np.exp(-margin)) - y
                else:
                    g = margin - y
                sw = fold_scale_pos_weight(p, y, blk.weight)
                if sw is not None:
                    g = g * sw
                gfeat = np.zeros(len(uids), np.float32)
                np.add.at(gfeat, inv, g[rows] * vals)
                grad = np.concatenate([gfeat + lam * w[:-1],
                                       [g.sum()]]) / n
                kv.push_sparse(name, ids, grad.astype(np.float32))
                kv.tick()
        kv.flush()
        self.last_fit_seconds = get_time() - t0
        if finalize:
            ids = np.arange(F + 1, dtype=np.int64)
            w = np.asarray(kv.pull_sparse(name, ids), np.float32)
            self.weights = w[:-1]
            self.bias = float(w[-1]) + p.base_score
        return self

    # -- inference ------------------------------------------------------
    def predict(self, X: np.ndarray,
                output_margin: bool = False) -> np.ndarray:
        """``X @ w + b`` on the device (sigmoid for ``binary:logistic``
        unless ``output_margin``), in batches of ``_PREDICT_BATCH`` rows."""
        CHECK(self.weights is not None, "predict before fit")
        X = np.ascontiguousarray(X, np.float32)
        w = torch.from_numpy(self.weights).to(self.device)
        logistic = (not output_margin
                    and self.param.objective == "binary:logistic")
        outs = []
        for lo in range(0, len(X), _PREDICT_BATCH):
            margin = (torch.from_numpy(X[lo:lo + _PREDICT_BATCH])
                      .to(self.device) @ w + self.bias)
            outs.append((_sigmoid(margin) if logistic else margin)
                        .cpu().numpy())
        if not outs:
            return np.zeros(0, np.float32)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def predict_iter(self, row_iter, output_margin: bool = False,
                     batch_rows: int = 2_000_000) -> np.ndarray:
        """Streaming prediction over a ``RowBlockIter``: one
        ``batch_rows`` slab at a time, never the dense matrix."""
        from dmlc_core_tpu_torch.data.iter import iter_dense_slabs

        CHECK(self.weights is not None, "predict before fit")
        F = len(self.weights)
        outs = [self.predict(xb, output_margin=output_margin)
                for xb, _, _ in iter_dense_slabs(row_iter, F, batch_rows)]
        if not outs:
            return np.zeros(0, np.float32)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    # -- checkpointing --------------------------------------------------
    def save_model(self, uri: str) -> None:
        """Hyperparameters and weights to a Stream URI: the JAX package's
        ``DMLCTPU.GBLIN.v1`` file."""
        from dmlc_core_tpu_torch.models.checkpoint import save_payload

        CHECK(self.weights is not None, "save_model before fit")
        save_payload(uri, self._MODEL_MAGIC, {
            "param": self.param.to_dict(),
            "weights": np.asarray(self.weights, np.float32),
            "bias": float(self.bias),
        })

    @classmethod
    def load_model(cls, uri: str,
                   device: Optional[Union[str, torch.device]] = None,
                   mesh: Optional[Mesh] = None) -> "GBLinear":
        """Inverse of :meth:`save_model`; reads either package's files."""
        from dmlc_core_tpu_torch.models.checkpoint import load_payload

        payload = load_payload(uri, cls._MODEL_MAGIC)
        model = cls(device=device, mesh=mesh, **payload["param"])
        model.weights = np.asarray(payload["weights"], np.float32)
        model.bias = float(payload["bias"])
        return model
