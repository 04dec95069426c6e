"""HistGBT external-memory engine (out-of-core boosting), PyTorch port.

The counterpart of ``dmlc_core_tpu/models/histgbt_external.py``: the
``fit_external`` side of :class:`~dmlc_core_tpu_torch.models.histgbt.
HistGBT` over a :class:`~dmlc_core_tpu_torch.data.iter.RowBlockIter` of
CSR pages — a streaming sketch pass, a binning pass, then boosting with
bounded device memory.

* **Pass 1** streams pages through a :class:`~dmlc_core_tpu_torch.ops.
  quantile.SketchAccumulator` (its cuts bit-equal to the JAX package's).
* **Pass 2** bins each page to the feature-major uint8 matrix (absent CSR
  entries bin as 0.0, as in JAX) and keeps the pages on the host.
* **The cached route**: when the binned rows and their per-row state fit
  ``DMLC_TPU_EXTERNAL_DEVICE_BUDGET`` (bytes, default 6 GiB) and nothing
  is sampled, the pages go up once as one matrix and the in-core boosting
  loop runs (:meth:`HistGBT._boost`).
* **The chunked route** otherwise: pages stack into chunks sized so that
  one chunk's bins plus the resident per-row state (y, w, node, margins,
  g, h) fit the budget, and the in-core loop runs over the chunks
  (``dd["chunks"]``).  Per level, each chunk's bins go up once (once in
  all when a single chunk holds every row), each chunk advances its rows
  (``descend_kernel`` on the card) and B1 builds its left children
  (``hist_kernel``); the chunks' int64 fixed-point sums add up before one
  conversion, and the right child is parent − left.  The final advance
  gives each row its leaf.  The fixed-point scale of a tree comes from
  the whole resident g/h, never per chunk, so the chunked route, the
  cached route and the in-core ``fit(X, y, cuts=)`` write the same model
  file when nothing is sampled.  Sampling uses the JAX package's numpy
  draws (``default_rng([seed, round, 1])`` for columns, ``[seed, round,
  2, rank]`` per page for rows), bit-equal by construction.

Leaves come from the deepest level's summed histogram at each split, as
in the in-core fit (the JAX chunked route takes separate leaf sums; in
the port those equal the in-core fit's only this way).

Under ``DMLC_METRICS_GBT_PHASES=1`` (with metrics on) the chunked route
waits for the device after each phase of a tree — each chunk's descend
and histogram, the split scan, each chunk's final descend and its leaf
gather — and observes its seconds into ``gbt_phase_seconds{engine=
"external", phase="hist" | "split" | "leaf" | "apply"}``, the JAX
engine's names (``HistGBT._grow_tree``); off (the default), nothing
synchronises.  The kernels' build starts after pass 2, beside the pages'
concat and upload (the cold-start handle of ``HistGBT``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.parameter import get_env
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.models.gbt_objectives import fold_scale_pos_weight
from dmlc_core_tpu_torch.models.gbt_split import (_host_bin_requested,
                                                  _host_bin_t)
from dmlc_core_tpu_torch.ops.quantile import SketchAccumulator, apply_bins
from dmlc_core_tpu_torch.parallel import collectives as coll

__all__ = ["_ExternalMemoryEngine"]

#: bytes of per-row state a chunked fit keeps on the device: y, w, node
#: (4 B each) and margins, g, h (4 B each per class)
_ROW_STATE = (12, 12)


class _ExternalMemoryEngine:
    """Out-of-core training methods mixed into :class:`HistGBT`; they
    rely on its param, mesh, objective, in-core boosting loop and tree
    growth."""

    def fit_external(self, row_iter, num_col: Optional[int] = None,
                     eval_every: int = 0, sketch_pages: int = 32,
                     cuts: Optional[Any] = None, cache_device: bool = False,
                     warmup_rounds: int = 0) -> "HistGBT":  # noqa: F821
        """Out-of-core boosting over a ``RowBlockIter`` — the JAX
        package's ``fit_external``, parameters and refusals included.

        ``cuts`` skips the sketch pass.  ``cache_device=True`` forces the
        whole binned set onto the device whatever the budget (one rank:
        the cached route).  A model that has trees continues from them:
        the existing margins are replayed over the binned pages first,
        and sampling draws use the global round index.  On several ranks
        each rank passes its own pages; the sketch merges over the ranks
        and the chunked route sums each level's int64 histograms over
        them.  Times: :attr:`last_sketch_seconds`,
        :attr:`last_bin_seconds` (pass 2), :attr:`last_fit_seconds`;
        :attr:`last_external_route` is ``"cached"`` or ``"chunked"``."""
        p = self.param
        CHECK(not (p.monotone_constraints
                   and any(int(v) for v in p.monotone_constraints)),
              "fit_external: monotone_constraints not supported — use fit()")
        CHECK(not p.objective.startswith("rank:"),
              f"fit_external: {p.objective} needs the grouped in-core "
              "layout — use fit(X, y, qid=...)")
        CHECK(not self._missing,
              "fit_external: this model was trained in missing mode "
              "(NaN bin + learned directions); the streaming engine "
              "builds standard cuts and would silently misread the top "
              "value bin as missing mass — continue with fit(), or use "
              "a fresh model")
        if p.scale_pos_weight != 1.0:
            CHECK(p.objective == "binary:logistic",
                  f"scale_pos_weight only applies to binary:logistic "
                  f"(objective is {p.objective!r})")
        B = p.n_bins
        distributed = self.mesh.size > 1
        self._rank_pos = None

        # -- pass 1: streaming sketch --------------------------------------
        t0 = get_time()
        F = max(num_col or 0, row_iter.num_col)
        if distributed:
            # one global width for the sketch gather and the histograms
            F = int(coll.allreduce(np.asarray([F], np.int64), op="max")[0])
        CHECK(F > 0, "fit_external: empty input")
        if cuts is not None:        # numpy, or a model's own tensor cuts
            self.cuts = torch.as_tensor(cuts, dtype=torch.float32,
                                        device=self.device)
        else:
            sketch: Optional[SketchAccumulator] = None
            for block in row_iter:
                if sketch is None:
                    sketch = SketchAccumulator(F, n_summary=max(8 * B, 64),
                                               buffer_pages=sketch_pages,
                                               device=self.device)
                sketch.add(block.to_dense(F), fold_scale_pos_weight(
                    p, block.label, block.weight))
            CHECK(sketch is not None, "fit_external: empty input")
            self.cuts = sketch.finalize(
                B, allgather_fn=coll.allgather if distributed else None)
        self.last_sketch_seconds = get_time() - t0

        # -- pass 2: bin the pages (uint8, feature-major) ------------------
        t1 = get_time()
        K = p.num_class
        host_bin = _host_bin_requested()
        cuts_np = self.cuts.cpu().numpy() if host_bin else None
        pages: List[Dict[str, Any]] = []
        for block in row_iter:
            X = block.to_dense(F)
            CHECK(not np.isnan(X).any(),
                  "fit_external: NaN features are only supported by "
                  "the in-core fit (learned missing direction) — "
                  "impute before streaming, or fit in-core")
            if host_bin:
                bins = _host_bin_t(X, cuts_np)
            else:
                bins = apply_bins(torch.from_numpy(X).to(self.device),
                                  self.cuts)
                if not cache_device:
                    bins = bins.cpu().numpy()       # one page on the device
            y = np.asarray(block.label, np.float32)
            w = (np.asarray(block.weight, np.float32)
                 if block.weight is not None else np.ones(len(X), np.float32))
            pages.append({"bins": bins, "y": y,
                          "w": fold_scale_pos_weight(p, y, w)})
        if K > 1:
            for pg in pages:
                if len(pg["y"]):
                    CHECK(pg["y"].min() >= 0 and pg["y"].max() < K,
                          f"multi:softmax labels must be in [0, {K})")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_bin_seconds = get_time() - t1

        N = sum(len(pg["y"]) for pg in pages)
        # the kernels' build starts now, beside the pages' concat and
        # upload (the cold-start handle the boosting loop joins)
        self._maybe_start_warmup(F, N, eval_every)
        budget = get_env("DMLC_TPU_EXTERNAL_DEVICE_BUDGET", 6 << 30, int)
        row_state = _ROW_STATE[0] + _ROW_STATE[1] * K
        no_sampling = p.subsample >= 1.0 and p.colsample_bytree >= 1.0
        if not distributed and (cache_device or (
                no_sampling and N * (2 * F + row_state) <= budget)):
            LOG("INFO", "fit_external: %d rows x %d feats on the device "
                "(budget %d MiB; DMLC_TPU_EXTERNAL_DEVICE_BUDGET) - the "
                "cached route", N, F, budget >> 20)
            return self._fit_external_cached(pages, F, eval_every,
                                             warmup_rounds)
        return self._fit_external_chunked(pages, F, eval_every, budget,
                                          cache_device, warmup_rounds)

    def _fit_external_cached(self, pages: List[Dict[str, Any]], F: int,
                             eval_every: int, warmup_rounds: int
                             ) -> "HistGBT":  # noqa: F821
        """The binned pages as one device matrix, boosted by the in-core
        loop (host pages concatenate on the host: one upload)."""
        self.last_external_route = "cached"
        y = np.concatenate([pg["y"] for pg in pages])
        w = np.concatenate([pg["w"] for pg in pages])
        if isinstance(pages[0]["bins"], np.ndarray):
            bins_t = torch.from_numpy(np.concatenate(
                [pg["bins"] for pg in pages], axis=1)).to(self.device)
        else:
            bins_t = torch.cat([pg["bins"] for pg in pages], dim=1)
        pages.clear()
        n = len(y)
        dd = {"bins_t": bins_t.contiguous(),
              "y_d": torch.from_numpy(y).to(self.device),
              "w_d": torch.from_numpy(w).to(self.device),
              "n": n, "n_global": n, "n_features": F, "layout": None}
        n_prior = len(self.trees)
        preds = self._base_margin(n)
        if n_prior:
            preds = self._apply_trees(dd["bins_t"], self.trees, preds)
        return self._boost(dd, preds, n_prior, warmup_rounds=warmup_rounds,
                           eval_every=eval_every)

    def _ext_sample_masks(self, r: int, page_rows: List[int], F: int
                          ) -> Tuple[Optional[np.ndarray],
                                     Optional[np.ndarray]]:
        """Round ``r``'s (row keep mask [N] f32 | None, feature mask [F]
        bool | None) — the JAX package's numpy draws: the ``ceil(c·F)``
        smallest of ``default_rng([seed, r, 1]).random(F)``, and per page
        in stream order ``default_rng([seed, r, 2, rank]).random(rows) <
        subsample``."""
        p = self.param
        keep = feat_mask = None
        if p.colsample_bytree < 1.0:
            crng = np.random.default_rng([p.seed, r, 1])
            n_keep = max(1, int(np.ceil(p.colsample_bytree * F)))
            scores = crng.random(F)
            feat_mask = scores <= np.sort(scores)[n_keep - 1]
        if p.subsample < 1.0:
            rrng = np.random.default_rng([p.seed, r, 2, self.mesh.rank])
            keep = np.concatenate(
                [(rrng.random(pr) < p.subsample).astype(np.float32)
                 for pr in page_rows] or [np.zeros(0, np.float32)])
        return keep, feat_mask

    def _fit_external_chunked(self, pages: List[Dict[str, Any]], F: int,
                              eval_every: int, budget: int,
                              cache_all: bool, warmup_rounds: int
                              ) -> "HistGBT":  # noqa: F821
        """Bounded-device-memory boosting over chunks of the pages (see
        the module docstring), by the in-core loop over the chunks.
        :attr:`last_upload_bytes` counts the bin bytes uploaded by the
        kept rounds."""
        p = self.param
        dev = self.device
        K = p.num_class
        self.last_external_route = "chunked"
        page_rows = [len(pg["y"]) for pg in pages]
        N = sum(page_rows)
        CHECK(N > 0, "fit_external: no rows")
        row_state = _ROW_STATE[0] + _ROW_STATE[1] * K
        if cache_all:
            rows_per_chunk = N
        else:
            avail_bins = budget - N * row_state
            CHECK(avail_bins > F,
                  f"DMLC_TPU_EXTERNAL_DEVICE_BUDGET={budget} cannot hold "
                  f"the always-resident per-row state ({N} rows x "
                  f"{row_state} B = {N * row_state} B) plus one row of "
                  f"bins.  Raise the budget toward the card's memory, "
                  f"shard rows across more workers (each worker's floor "
                  f"is its own shard only), or force residency with "
                  f"cache_device=True")
            rows_per_chunk = min(N, max(int(avail_bins // F), 1))
        n_chunks = -(-N // rows_per_chunk)
        Rc = -(-N // n_chunks)
        bounds = [(lo, min(N, lo + Rc)) for lo in range(0, N, Rc)]
        resident = len(bounds) == 1

        # -- the pages as chunks: bins on the host (pinned for the card's
        # uploads) or resident; y, w, margins resident
        if isinstance(pages[0]["bins"], np.ndarray):
            allb = torch.from_numpy(np.concatenate(
                [pg["bins"] for pg in pages], axis=1))
        else:                               # cache_device: device pages
            allb = torch.cat([pg["bins"] for pg in pages], dim=1)
        y_all = np.concatenate([pg["y"] for pg in pages])
        w_all = np.concatenate([pg["w"] for pg in pages])
        pages.clear()
        bins_h = [allb[:, lo:hi].contiguous() for lo, hi in bounds]
        del allb
        if resident:
            bins_h = [b.to(dev) for b in bins_h]
        elif dev.type == "cuda":
            bins_h = [b.pin_memory() for b in bins_h]

        def chunk_bins(c: int):
            def get():
                if resident:
                    return bins_h[c]
                self.last_upload_bytes += bins_h[c].numel()
                return bins_h[c].to(dev, non_blocking=True)
            return get

        n_global = N
        if self.mesh.size > 1:
            n_global = int(coll.allreduce(np.asarray([N], np.int64))[0])
        dd = {"chunks": [(chunk_bins(c), lo, hi)
                         for c, (lo, hi) in enumerate(bounds)],
              "y_d": torch.from_numpy(y_all).to(dev),
              "w_d": torch.from_numpy(w_all).to(dev),
              "n": N, "n_global": n_global, "n_features": F, "layout": None}
        self.last_external_chunks = len(bounds)
        self.last_upload_bytes = 0
        n_prior = len(self.trees)
        preds = self._base_margin(N)
        if n_prior:
            # the existing ensemble's margins, chunk by chunk
            preds = torch.cat([self._apply_trees(get(), self.trees,
                                                 preds[lo:hi])
                               for get, lo, hi in dd["chunks"]])

        def masks(r: int):
            keep, fmask = self._ext_sample_masks(r, page_rows, F)
            return (None if keep is None else torch.from_numpy(keep > 0
                                                               ).to(dev),
                    None if fmask is None else torch.from_numpy(fmask
                                                                ).to(dev))

        self._boost(dd, preds, n_prior, warmup_rounds=warmup_rounds,
                    eval_every=eval_every, masks=masks)
        # each rank's margins are over its own pages, not a shard of one
        # global row order: no train_margins, as in the JAX package
        self._train_preds = None
        return self
