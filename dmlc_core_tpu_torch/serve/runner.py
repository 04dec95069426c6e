"""Padded-batch model executor with power-of-two shape buckets.

The counterpart of ``dmlc_core_tpu/serve/runner.py``.  In the JAX
package every distinct input shape is a fresh XLA compilation, and live
traffic produces arbitrary batch sizes, so :class:`ModelRunner` routes
any request batch into a small fixed ladder of power-of-two row buckets
— the batch is zero-padded up to the next bucket, executed through the
wrapped model's own predict, and the pad rows sliced off the result.
The port compiles nothing per shape: its CUDA kernels are built once
into the build directory (``ops/_build.py``) and eager torch allocates
per call, so the JAX package's persistent compile cache
(``_cc.configure()``) has no counterpart.  The ladder stays all the
same: the batcher and the frontend's ``max_batch`` contract rest on it,
and ``compiled_shapes`` keeps its meaning — the bucket shapes executed,
at most ``log2(max_batch) + 1`` of them, each logged once.

On a card, a served ``HistGBT`` batch runs ``descend_kernel`` (B2's
descend, ``ops/histogram.py``) once per tree and level through
``HistGBT.predict``.  :meth:`ModelRunner.warmup` builds and loads the
kernels and touches the CUDA context before the first live request; the
batcher's flush thread, not the caller's, then runs ``predict``, so each
call runs under ``torch.cuda.device(model.device)`` — the model's own
card, never the thread's current device.  A runner on a ``cuda`` model
never runs on the CPU.

Padding is semantically invisible: every bundled model predicts row-wise
(binning, tree descent, matvec are all per-row), so appending zero rows
cannot change real-row outputs — ``tests/test_serve.py`` pins exact
(bit-identical) single-row vs batched parity across model families.

Model families are adapted uniformly:

* anything with ``predict(X)`` over dense rows — :class:`HistGBT`,
  :class:`GBLinear`, :class:`FM`, the external-memory GBT (same class);
* :class:`SparseHistGBT` — dense request rows are expanded to an
  all-entries-present CSR (a dense row's zeros are VALUES, not absence);
* the sklearn wrappers — routed through ``_predict_native`` so the
  objective's output transform is applied, including the wrapper's own
  sparse-model path (explicit-zero scipy CSR keeps value semantics).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.parameter import get_env
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.serve.instruments import serve_metrics

__all__ = ["ModelRunner"]


def _infer_n_features(model: Any) -> Optional[int]:
    """Feature width of a wrapped model, when its family exposes one —
    what bucket pre-warm needs to synthesize zero batches.  sklearn
    wrappers unwrap to their native engine first."""
    inner = getattr(model, "model", None)
    if inner is not None and hasattr(model, "_predict_native"):
        model = inner
    cuts = getattr(model, "cuts", None)            # HistGBT family
    if cuts is not None and hasattr(cuts, "shape"):
        return int(cuts.shape[0])
    for attr in ("n_features", "_n_features"):     # sparse GBT, FM
        v = getattr(model, attr, None)
        if v:
            return int(v)
    w = getattr(model, "weights", None)            # GBLinear
    if w is not None:
        return int(np.asarray(w).shape[0])
    return None


def _model_device(model: Any):
    """The CUDA device a model (or a wrapper's booster) lives on, or
    None for a CPU model or one without a ``device``."""
    inner = getattr(model, "_model", None)
    if inner is not None and hasattr(model, "_predict_native"):
        model = inner
    dev = getattr(model, "device", None)
    return dev if getattr(dev, "type", None) == "cuda" else None


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _dense_as_csr(X: np.ndarray):
    """Dense rows → (offset, index, value) CSR with EVERY entry present.

    A dense request row means "here are all F values", so the CSR the
    sparse engine sees must carry explicit entries for zeros — dropping
    them (scipy's default densify inverse) would silently turn value-0
    into absent ≡ missing and change predictions."""
    n, F = X.shape
    offset = np.arange(0, n * F + 1, F, dtype=np.int64)
    index = np.tile(np.arange(F, dtype=np.int64), n)
    return offset, index, np.ascontiguousarray(X.reshape(-1), np.float32)


def _native_predict_fn(model: Any) -> Callable[[np.ndarray], np.ndarray]:
    """Resolve a uniform dense-rows → predictions callable for any
    supported model family (see module docstring)."""
    if hasattr(model, "_predict_native"):        # sklearn wrappers
        def call_wrapper(X: np.ndarray) -> np.ndarray:
            from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT

            if isinstance(model.model, SparseHistGBT):
                import scipy.sparse as sp

                n, F = X.shape
                offset, index, value = _dense_as_csr(X)
                csr = sp.csr_matrix((value, index, offset), shape=(n, F))
                return np.asarray(model._predict_native(csr))
            return np.asarray(model._predict_native(X))

        return call_wrapper
    if type(model).__name__ == "SparseHistGBT":   # native sparse engine
        def call_sparse(X: np.ndarray) -> np.ndarray:
            offset, index, value = _dense_as_csr(X)
            return np.asarray(model.predict(offset, index, value))

        return call_sparse
    CHECK(hasattr(model, "predict"),
          f"ModelRunner: {type(model).__name__} has no predict()")
    return lambda X: np.asarray(model.predict(X))


class ModelRunner:
    """Wrap a trained model into a bucket-padded batch executor.

    ``max_batch`` and ``min_bucket`` must be powers of two; request
    batches larger than ``max_batch`` are chunked.  The runner is
    stateless between calls apart from the compiled-shape audit set and
    is safe to call from one executor thread at a time (the batcher's
    flush thread) — serial execution is the contract the batcher
    provides.
    """

    def __init__(self, model: Any, max_batch: int = 1024,
                 min_bucket: int = 8, name: str = "default",
                 prewarm: Optional[bool] = None):
        CHECK(_is_pow2(max_batch),
              f"max_batch must be a power of two, got {max_batch}")
        CHECK(_is_pow2(min_bucket) and min_bucket <= max_batch,
              f"min_bucket must be a power of two <= max_batch, "
              f"got {min_bucket}")
        self.model = model
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        #: metrics label — a role name, not a per-instance id
        self.name = name
        self._predict = _native_predict_fn(model)
        self._device = _model_device(model)
        self._n_features = _infer_n_features(model)
        #: bucket sizes whose shape has been executed — the audit
        #: surface for the log2(max_batch)+1 shape bound
        self.compiled_shapes: set = set()
        if prewarm is None:
            prewarm = get_env("DMLC_SERVE_PREWARM", False, bool)
        if prewarm:
            self.warmup()

    def warmup(self, n_features: Optional[int] = None) -> float:
        """Eagerly execute every ladder bucket on zero rows so the
        first LIVE request per bucket does not pay that bucket's first use
        (env-gate the constructor's call with ``DMLC_SERVE_PREWARM=1``
        — registry-published runners inherit it).  On a card this builds
        and loads the kernels and creates the CUDA context and the
        caching allocator's blocks for every bucket.  Progress is visible
        on the ``serve_compiled_shapes`` gauge, which reaches
        ``shape_bound`` when the runner is fully warm.  Returns wall
        seconds.
        """
        F = n_features or self._n_features
        CHECK(F, f"ModelRunner.warmup: cannot infer n_features from "
              f"{type(self.model).__name__} — pass n_features=")
        t0 = get_time()
        b = self.min_bucket
        while b <= self.max_batch:
            self._predict_bucket(np.zeros((b, F), np.float32))
            b <<= 1
        wall = get_time() - t0
        LOG("INFO", "serve.runner %s: pre-warmed %d bucket shapes "
            "in %.2fs", self.name, len(self.compiled_shapes), wall)
        return wall

    @property
    def n_features(self) -> Optional[int]:
        """Feature width inferred from the model (None when the family
        exposes no width — callers must then pass ``n_features=`` to
        :meth:`warmup`).  The tenancy pager keys its restore warmups on
        this so a page-in re-warms the exact ladder the eviction
        dropped."""
        return self._n_features

    @property
    def shape_bound(self) -> int:
        """Maximum distinct batch shapes this runner can ever execute:
        one per bucket on the [min_bucket, max_batch] pow-2 ladder."""
        return (self.max_batch.bit_length()
                - self.min_bucket.bit_length() + 1)

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket holding ``n`` rows (n <= max_batch)."""
        CHECK(1 <= n <= self.max_batch,
              f"bucket_for: n={n} outside [1, {self.max_batch}]")
        return max(self.min_bucket, 1 << (n - 1).bit_length())

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Score ``[n, F]`` dense rows (any n >= 1); returns predictions
        for exactly the real rows, in order."""
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        CHECK(X.ndim == 2 and len(X) >= 1,
              f"ModelRunner.predict: want [n, F] rows, got {X.shape}")
        outs = [self._predict_bucket(X[lo:lo + self.max_batch])
                for lo in range(0, len(X), self.max_batch)]
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    __call__ = predict

    def _run(self, xb: np.ndarray) -> np.ndarray:
        """The model's predict on its own card (the caller may be any
        thread)."""
        if self._device is None:
            return self._predict(xb)
        import torch

        with torch.cuda.device(self._device):
            return self._predict(xb)

    def _predict_bucket(self, xb: np.ndarray) -> np.ndarray:
        k = len(xb)
        b = self.bucket_for(k)
        if b > k:
            xb = np.concatenate(
                [xb, np.zeros((b - k, xb.shape[1]), np.float32)])
        if b not in self.compiled_shapes:
            self.compiled_shapes.add(b)
            LOG("INFO",
                "serve.runner %s: new batch bucket %d rows "
                "(%d distinct shapes so far; bound log2(max_batch)+1 = %d)",
                self.name, b, len(self.compiled_shapes), self.shape_bound)
            if _metrics.enabled():
                serve_metrics()["compiled_shapes"].set(
                    len(self.compiled_shapes), runner=self.name)
        if _metrics.enabled():
            m = serve_metrics()
            m["rows"].inc(k, runner=self.name)
            m["pad_rows"].inc(b - k, runner=self.name)
            with m["execute"].time(runner=self.name):
                preds = self._run(xb)
        else:
            preds = self._run(xb)
        return np.asarray(preds)[:k]
