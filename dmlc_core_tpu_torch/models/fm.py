"""Factorization machines — the LibFM-format consumer (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/fm.py``.  Second-order FM
(Rendle 2010):

    ŷ(x) = w₀ + Σᵢ wᵢxᵢ + ½ Σ_k [(Σᵢ v_{ik} xᵢ)² − Σᵢ v_{ik}² xᵢ²]

computed with the O(n·k) identity — two dense ``[B, F] × [F, K]``
products a batch (:func:`_fm_margin`; JAX computes them outside any
Pallas kernel, so they stay ``torch.matmul`` here).  Rows of a batch are
split over the port's data axis (one process per GPU, ``parallel.mesh``);
each rank takes the gradient of its LOCAL weighted loss sum, the ranks
sum the gradients, the loss and the weight in one ``all_reduce`` (JAX's
``psum``), divide by the global weight and add the analytic L2 terms;
then Adam with f32 state, written as JAX writes it:
``w − lr·mhat / (sqrt(shat) + eps)`` with ``b1 ** t`` in f32 (not
``torch.optim.Adam``, whose rounding order and float64 bias corrections
differ).

The gradient is analytic, not ``torch.autograd``: with ``d`` the loss's
derivative in each row's margin (``sigmoid(m) − y`` or ``m − y``, times
the row weight), ``∂w₀ = Σd``, ``∂w = Xᵀd`` and
``∂v = Xᵀ(d·XV) − v ⊙ ((X·X)ᵀd)`` — the terms JAX's autodiff forms,
without a graph.

Batches are JAX's: ``fit`` permutes the rows with
``np.random.default_rng(seed)`` each call, pads every batch to
``batch_size`` (rounded up to the world size) with weight-0 rows, and
reads the loss with ``float(loss)``, one sync a step; ``fit_iter``
densifies each ``RowBlockIter`` page (missing = 0).  The initial ``v``
is drawn from ``np.random.default_rng(seed)`` on the host, bit-equal to
the JAX package's.  JAX's compiled-step cache (``_STEP_FN_CACHE``) has
no counterpart: eager torch compiles nothing.  ``fit_ps`` is sparse
FM-SGD over a dist_async KVStore (``parallel/ps``): JAX's host arithmetic
over CSR minibatches, line for line; ``finalize=True`` puts the pulled
``w0``, ``w`` and ``v`` on the model's device, so ``predict`` runs there.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ
from dmlc_core_tpu_torch.base.parameter import Parameter, field
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import (Mesh, local_mesh,
                                               shard_row_ranges)
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["FM", "FMParam"]

#: the parameters, in the JAX package's (sorted pytree) order
_KEYS = ("v", "w", "w0")
#: rows per predict batch on the device
_PREDICT_BATCH = 1_000_000


class FMParam(Parameter):
    """Hyperparameters (libFM-compatible names where they exist)."""

    n_factors = field(int, default=8, lower_bound=1, description="k")
    learning_rate = field(float, default=0.05, lower_bound=0.0)
    reg_w = field(float, default=1e-4, lower_bound=0.0,
                  description="L2 on linear weights")
    reg_v = field(float, default=1e-4, lower_bound=0.0,
                  description="L2 on factor matrix")
    n_epochs = field(int, default=10, lower_bound=1)
    batch_size = field(int, default=8192, lower_bound=16)
    objective = field(str, default="binary:logistic",
                      enum=["binary:logistic", "reg:squarederror"])
    init_scale = field(float, default=0.01, lower_bound=0.0)
    seed = field(int, default=0)


def _fm_terms(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """``(margin, x @ v)`` for dense ``x [B, F]``."""
    lin = x @ params["w"] + params["w0"]                    # [B]
    xv = x @ params["v"]                                    # [B, K]
    x2v2 = (x * x) @ (params["v"] * params["v"])            # [B, K]
    return lin + 0.5 * torch.sum(xv * xv - x2v2, dim=1), xv


def _fm_margin(params: Dict[str, torch.Tensor], x: torch.Tensor
               ) -> torch.Tensor:
    """ŷ raw margin for dense ``x [B, F]`` — O(B·F·k) via the FM
    identity."""
    return _fm_terms(params, x)[0]


class FM:
    """Train/predict API on one device per process (``device``: ``cuda``
    by default, or ``cpu``; ``mesh``: the data axis).

    ``fit(X, y)`` for in-core dense arrays; ``fit_iter(row_iter)`` streams
    :class:`~dmlc_core_tpu_torch.data.iter.RowBlockIter` pages."""

    _MODEL_MAGIC = b"DMLCTPU.FM.v1\n"

    def __init__(self, param: Optional[FMParam] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None, **kwargs: Any):
        self.param = param or FMParam()
        if kwargs:
            self.param.init(kwargs)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh()
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self._opt: Optional[Dict[str, Any]] = None
        self._n_features: Optional[int] = None
        self.last_fit_seconds: Optional[float] = None
        self.last_loss: Optional[float] = None

    # -- setup ----------------------------------------------------------
    def _init_state(self, n_features: int) -> None:
        p = self.param
        rng = np.random.default_rng(p.seed)
        self.params_from_numpy({
            "w0": np.zeros((), np.float32),
            "w": np.zeros(n_features, np.float32),
            "v": (rng.normal(size=(n_features, p.n_factors))
                  * p.init_scale).astype(np.float32),
        })

    def params_from_numpy(self, params: Dict[str, np.ndarray],
                          opt: Optional[Dict[str, Any]] = None) -> None:
        """Load the parameters (and Adam's ``m``, ``s``, ``t``; zero when
        ``opt`` is omitted) given under the JAX package's names and
        shapes as numpy arrays — a JAX model's ``gather_tree(params)``
        and ``{"m": ..., "s": ..., "t": ...}``."""
        CHECK_EQ(sorted(params), sorted(_KEYS),
                 "params: the parameter names differ from FM's")
        F, K = np.shape(params["v"])
        CHECK_EQ(K, self.param.n_factors, "params: v's width != n_factors")
        CHECK_EQ(np.shape(params["w"]), (F,), "params: w shape")
        # a file's w0 reads back as [1] (the serializer writes a 0-d
        # array as 1-d, in both packages): the scalar either way
        CHECK_EQ(np.size(params["w0"]), 1, "params: w0 must be a scalar")
        shapes = {"v": (F, K), "w": (F,), "w0": ()}

        def load(tree):     # a copy: the caller keeps its arrays
            return {k: torch.as_tensor(np.array(tree[k], np.float32)
                                       .reshape(shapes[k]),
                                       device=self.device) for k in _KEYS}

        self._n_features = int(F)
        self.params = load(params)
        if opt is None:
            zeros = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self._opt = {"m": zeros,
                         "s": {k: v.clone() for k, v in zeros.items()},
                         "t": torch.zeros((), dtype=torch.int32,
                                          device=self.device)}
        else:
            self._opt = {"m": load(opt["m"]), "s": load(opt["s"]),
                         "t": torch.tensor(int(opt["t"]), dtype=torch.int32,
                                           device=self.device)}

    # -- training -------------------------------------------------------
    def _step(self, x: torch.Tensor, y: torch.Tensor, wt: torch.Tensor
              ) -> torch.Tensor:
        """One Adam step on this rank's rows of a batch; returns the
        global loss (a device scalar)."""
        p = self.param
        ps = self.params
        lr, b1, b2, eps = p.learning_rate, 0.9, 0.999, 1e-8
        margin, xv = _fm_terms(ps, x)
        if p.objective == "binary:logistic":
            per_row = torch.logaddexp(margin, torch.zeros_like(margin)) \
                - y * margin                           # logloss on margin
            d = (torch.sigmoid(margin) - y) * wt
        else:
            per_row = 0.5 * (margin - y) ** 2
            d = (margin - y) * wt
        F, K = ps["v"].shape
        gv = x.T @ (d[:, None] * xv) - ps["v"] * ((x * x).T @ d)[:, None]
        # one collective: the gradients, the loss sum and the weight sum
        flat = torch.cat([d.sum().reshape(1), x.T @ d, gv.reshape(-1),
                          torch.sum(per_row * wt).reshape(1),
                          wt.sum().reshape(1)])
        coll.device_allreduce(flat, self.mesh)
        n_glob = flat[-1]
        grads = {"w0": flat[0] / n_glob, "w": flat[1:1 + F] / n_glob,
                 "v": flat[1 + F:1 + F + F * K].reshape(F, K) / n_glob}
        # analytic L2 terms (the reg term is replicated, not sharded)
        grads["w"] = grads["w"] + 2 * p.reg_w * ps["w"]
        grads["v"] = grads["v"] + 2 * p.reg_v * ps["v"]
        loss = (flat[-2] / n_glob + p.reg_w * torch.sum(ps["w"] ** 2)
                + p.reg_v * torch.sum(ps["v"] ** 2))
        opt = self._opt
        t = opt["t"] + 1
        tf = t.to(torch.float32)
        c1 = 1 - torch.pow(b1, tf)
        c2 = 1 - torch.pow(b2, tf)
        new_m, new_s, new_p = {}, {}, {}
        for k in _KEYS:
            m = b1 * opt["m"][k] + (1 - b1) * grads[k]
            s = b2 * opt["s"][k] + (1 - b2) * grads[k] * grads[k]
            mhat = m / c1
            shat = s / c2
            new_m[k], new_s[k] = m, s
            new_p[k] = ps[k] - lr * mhat / (torch.sqrt(shat) + eps)
        self.params = new_p
        self._opt = {"m": new_m, "s": new_s, "t": t}
        return loss

    def _run_batch(self, xb: np.ndarray, yb: np.ndarray,
                   wb: np.ndarray) -> float:
        """Pad the batch to the fixed ``batch_size`` (rounded up to the
        world size) with weight-0 rows, as JAX pads to one compiled
        shape, step on this rank's share and fetch the loss."""
        ndev = self.mesh.size
        target = self.param.batch_size + (-self.param.batch_size) % ndev
        pad = max(target, ndev) - len(yb)
        if pad:
            xb = np.concatenate([xb, np.zeros((pad, xb.shape[1]),
                                              np.float32)])
            yb = np.concatenate([yb, np.zeros(pad, np.float32)])
            wb = np.concatenate([wb, np.zeros(pad, np.float32)])
        lo, hi = shard_row_ranges(len(yb), ndev)[self.mesh.rank]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(
                self.device)

        return float(self._step(put(xb), put(yb), put(wb)))

    def fit(self, X: np.ndarray, y: np.ndarray,
            weight: Optional[np.ndarray] = None) -> "FM":
        """``n_epochs`` passes over dense ``X`` in the JAX package's batch
        order (every rank the global rows)."""
        p = self.param
        X = np.ascontiguousarray(X, np.float32)
        y = np.ascontiguousarray(y, np.float32)
        CHECK_EQ(len(X), len(y), "X/y row mismatch")
        if self.params is None:
            self._init_state(X.shape[1])
        else:
            CHECK_EQ(X.shape[1], self._n_features, "feature-count mismatch")
        w = (np.ones(len(y), np.float32) if weight is None
             else np.asarray(weight, np.float32))
        rng = np.random.default_rng(p.seed)
        t0 = get_time()
        for _epoch in range(p.n_epochs):
            order = rng.permutation(len(y))
            for lo in range(0, len(y), p.batch_size):
                sel = order[lo:lo + p.batch_size]
                self.last_loss = self._run_batch(X[sel], y[sel], w[sel])
        self.last_fit_seconds = get_time() - t0
        return self

    def fit_iter(self, row_iter, num_col: Optional[int] = None) -> "FM":
        """Stream RowBlockIter pages (LibFM/LibSVM files) — one epoch per
        pass over the iterator, ``n_epochs`` passes."""
        p = self.param
        F = max(num_col or 0, row_iter.num_col)
        CHECK(F > 0, "fit_iter: empty input")
        if self.params is None:
            self._init_state(F)
        t0 = get_time()
        for _epoch in range(p.n_epochs):
            for block in row_iter:
                X = block.to_dense(F)
                y = np.asarray(block.label, np.float32)
                w = (np.asarray(block.weight, np.float32)
                     if block.weight is not None
                     else np.ones(len(y), np.float32))
                for lo in range(0, len(y), p.batch_size):
                    self.last_loss = self._run_batch(
                        X[lo:lo + p.batch_size], y[lo:lo + p.batch_size],
                        w[lo:lo + p.batch_size])
        self.last_fit_seconds = get_time() - t0
        return self

    def fit_ps(self, row_iter, kv, num_col: Optional[int] = None,
               batch_rows: int = 8192, name: str = "fm",
               finalize: bool = True) -> "FM":
        """Web-scale sparse FM-SGD over a parameter server (the JAX
        package's ``fit_ps``).

        Two PS arrays carry the model: ``{name}:w`` [F+1] (linear
        weights, bias at id F, zero-init) and ``{name}:v`` [F, k]
        (factors, server-side Normal(0, init_scale) init seeded by key
        range).  Each CSR minibatch pulls only the rows its feature ids
        touch, computes the exact FM gradient on the host via the
        O(nnz·k) identity, and pushes back asynchronously (server-side
        SGD).  One ``tick`` per minibatch; ``n_epochs`` passes.
        ``reg_w`` / ``reg_v`` apply lazily (touched rows only).
        ``finalize`` pulls both arrays into ``self.params`` on the
        model's device so :meth:`predict` works — skip it at true 10M+
        scale.
        """
        from dmlc_core_tpu_torch.data.iter import iter_csr_minibatches

        p = self.param
        F = max(num_col or 0, getattr(row_iter, "num_col", 0) or 0)
        CHECK(F > 0, "fit_ps: no columns (num_col unset and the "
                     "iterator reports width 0)")
        K = p.n_factors
        wname, vname = f"{name}:w", f"{name}:v"
        kv.init_sparse(wname, n_keys=F + 1)
        kv.init_sparse(vname, n_keys=F, width=(K,),
                       init_scale=p.init_scale, seed=p.seed)
        logistic = p.objective == "binary:logistic"
        t0 = get_time()
        for _epoch in range(p.n_epochs):
            for blk in iter_csr_minibatches(row_iter, batch_rows):
                n = blk.size
                vals = (np.asarray(blk.value, np.float32)
                        if blk.value is not None
                        else np.ones(blk.nnz, np.float32))
                uids, inv = np.unique(blk.index, return_inverse=True)
                wids = np.concatenate([uids, [F]])
                w = np.asarray(kv.pull_sparse(wname, wids), np.float32)
                V = np.asarray(kv.pull_sparse(vname, uids), np.float32)
                rows = np.repeat(np.arange(n),
                                 np.diff(blk.offset)).astype(np.int64)
                vnz = V[inv]                                  # [nnz, K]
                xnz = vals[:, None]
                lin = np.full(n, w[-1], np.float32)
                np.add.at(lin, rows, w[:-1][inv] * vals)
                xv = np.zeros((n, K), np.float32)             # Σ v·x
                np.add.at(xv, rows, vnz * xnz)
                x2v2 = np.zeros((n, K), np.float32)           # Σ v²x²
                np.add.at(x2v2, rows, vnz * vnz * xnz * xnz)
                margin = lin + 0.5 * np.sum(xv * xv - x2v2, axis=1)
                y = np.asarray(blk.label, np.float32)
                if logistic:
                    g = 1.0 / (1.0 + np.exp(-margin)) - y
                else:
                    g = margin - y
                if blk.weight is not None:
                    g = g * blk.weight
                gr = g[rows]                                  # [nnz]
                gw = np.zeros(len(uids), np.float32)
                np.add.at(gw, inv, gr * vals)
                gv = np.zeros((len(uids), K), np.float32)
                np.add.at(gv, inv,
                          gr[:, None] * (xnz * xv[rows] - vnz * xnz * xnz))
                kv.push_sparse(wname, wids, np.concatenate(
                    [gw + 2 * p.reg_w * w[:-1], [g.sum()]]) / n)
                kv.push_sparse(vname, uids,
                               (gv + 2 * p.reg_v * V) / n)
                kv.tick()
        kv.flush()
        self.last_fit_seconds = get_time() - t0
        if finalize:
            wfull = np.asarray(
                kv.pull_sparse(wname, np.arange(F + 1, dtype=np.int64)),
                np.float32)
            vfull = np.asarray(
                kv.pull_sparse(vname, np.arange(F, dtype=np.int64)),
                np.float32)
            if self.params is None:
                self._init_state(F)

            def put(a):
                return torch.as_tensor(np.array(a, np.float32),
                                       device=self.device)

            self.params = {"v": put(vfull), "w": put(wfull[:-1]),
                           "w0": put(wfull[-1])}
        return self

    # -- checkpointing --------------------------------------------------
    def save_model(self, uri: str) -> None:
        """Hyperparameters, weights and Adam's state to a Stream URI: the
        JAX package's ``DMLCTPU.FM.v1`` file."""
        from dmlc_core_tpu_torch.models.checkpoint import (gather_tree,
                                                           save_payload)

        CHECK(self.params is not None, "save_model before fit")
        save_payload(uri, self._MODEL_MAGIC, {
            "param": self.param.to_dict(),
            "n_features": self._n_features,
            "params": gather_tree(self.params),
            "opt_m": gather_tree(self._opt["m"]),
            "opt_s": gather_tree(self._opt["s"]),
            "opt_t": int(self._opt["t"].cpu()),
        })

    @classmethod
    def load_model(cls, uri: str,
                   device: Optional[Union[str, torch.device]] = None,
                   mesh: Optional[Mesh] = None) -> "FM":
        """Inverse of :meth:`save_model` (either package's file); predicts
        at once and resumes training exactly (Adam's moments and step)."""
        from dmlc_core_tpu_torch.models.checkpoint import load_payload

        payload = load_payload(uri, cls._MODEL_MAGIC)
        model = cls(device=device, mesh=mesh, **payload["param"])
        model.params_from_numpy(payload["params"], {
            "m": payload["opt_m"], "s": payload["opt_s"],
            "t": payload["opt_t"]})
        CHECK_EQ(model._n_features, int(payload["n_features"]),
                 "FM file: n_features != v's rows")
        return model

    # -- inference ------------------------------------------------------
    def predict(self, X: np.ndarray, output_margin: bool = False
                ) -> np.ndarray:
        """Margins, or sigmoid probabilities for ``binary:logistic``, on
        the device in batches of ``_PREDICT_BATCH`` rows."""
        CHECK(self.params is not None, "predict before fit")
        X = np.ascontiguousarray(X, np.float32)
        CHECK_EQ(X.shape[1], self._n_features, "feature-count mismatch")
        logistic = (not output_margin
                    and self.param.objective == "binary:logistic")
        outs = []
        for lo in range(0, len(X), _PREDICT_BATCH):
            margin = _fm_margin(self.params, torch.from_numpy(
                X[lo:lo + _PREDICT_BATCH]).to(self.device))
            outs.append((torch.sigmoid(margin) if logistic else margin)
                        .cpu().numpy())
        if not outs:
            return np.zeros(0, np.float32)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]
