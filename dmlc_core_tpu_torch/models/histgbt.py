"""Histogram gradient-boosted trees on one GPU (PyTorch port).

The counterpart of ``dmlc_core_tpu/models/histgbt.py``'s in-core engine:
dense ``HistGBT`` training (``binary:logistic``, ``multi:softmax``,
``reg:squarederror``) with depth-wise or loss-guide growth, the bench's
bin levers, row and column sampling, monotone constraints, continued
training, prediction and introspection (``predict_leaf``,
``dump_model``, ``feature_importances``), and ``save_model`` /
``load_model`` in the same file format.

One device, eager: the round is a Python loop over trees and levels in
the JAX program's level order —

* quantile cuts and binning on the device (``ops.quantile``), giving the
  feature-major uint8 ``[F, n]`` bin matrix;
* with ``DMLC_BIN_PACK=1`` / ``DMLC_FEATURE_BUNDLE=1`` the matrix is
  re-laid out once (``ops.binlayout``: int4 pairs of narrow features,
  bundles of exclusive ones); histograms then stay in storage space and
  split scoring sees them unbundled to the original space;
* per tree, depth-wise (the default): grad/hess, then level 0
  ``build_histogram`` over all rows, each deeper level one ``fused_round``
  (descend + left-child histograms + sibling subtraction) with the split
  tables of the level above, split scoring on the emitted histograms, a
  final descend, leaf values ``−G/(H+λ)·η`` and ``preds += leaf[node]``;
* per tree, loss-guide (``DMLC_GROW_POLICY=lossguide``,
  ``DMLC_MAX_LEAVES``): the root histogram, then ``max_leaves − 1``
  expansions of the open leaf with the best gain, each one
  ``fused_round`` at ``n_prev=1`` over that leaf's rows, with the queue
  kept on the device (no host sync per expansion).

Trees are the JAX package's per-tree numpy arrays (``feat``, ``thr``,
``gain`` ``[depth, 2^(depth-1)]``, ``leaf`` ``[2^depth]``), in the original
feature and bin space whatever the levers, so model files and their
consumers are unchanged.  ``multi:softmax`` grows K trees a round, one per
class on that class's column of the softmax gradients, each through the
same kernels, and stacks them ``[K, ...]`` (margins ``[n, K]``).

Sampling (``subsample``, ``colsample_bytree``) draws JAX's masks bit for
bit (``utils.prng``, threefry2x32): a chunk's key is ``fold_in(key(seed),
global round)``, each round splits it, the row key folds in the rank.
Continued training (``fit`` on a fitted model, ``fit_device(resume=True)``)
keeps the cuts, replays the ensemble's margins tree by tree (or takes the
carried ones) and threads the global round index, so that 3 + 2 rounds
write the 5-round file.

Data parallel (``mesh=``, a :class:`~dmlc_core_tpu_torch.parallel.mesh.
Mesh` over a ``torch.distributed`` group, one process per GPU): every
rank passes the same global ``X, y``, derives the same cuts from it and
keeps its rows ``shard_row_ranges(n, world)[rank]``.  Histograms are
accumulated per rank as int64 fixed point, summed over ranks by one
``all_reduce`` (the ``sync=`` seam of ``ops.histogram``) and only then
converted and subtracted (``prev − left``), so an N-rank fit writes the
1-rank fit's bytes.  The fixed-point scales take the global ``max|g|``,
``max|h|`` and row count, and layouts the global occupancy.  Without the
fused round a level is ``fused_descend_histogram`` (``fuse`` from
``DMLC_TPU_FUSED_DESCEND``), the sync, then the subtraction, as JAX's
chain.  ``DMLC_HIST_BLOCKS`` keeps its checks and turns the fused round
off, as in JAX; with integer sums JAX's per-block builds and
``_tree_fold`` give the bytes of one build, so the port builds once per
level (``_tree_fold`` is kept for its parity test).  ``DMLC_HIST_QUANT``
(several ranks, no blocks) is JAX's approximate int8 code sync.

Rounds run in chunks of ``DMLC_TPU_ROUNDS_PER_DISPATCH`` (default 25):
the trees of a chunk stay on the device and come to the host in one
fetch, whose arrival time is the chunk's timestamp
(``last_chunk_times``), as the JAX package's dispatch chunks.
``fit_device(warmup_rounds=k)`` first runs ``k`` discarded rounds on a
copy of the margins (the first use of every kernel and torch op), and
:meth:`HistGBT.start_warmup` builds and loads the CUDA kernels on a
thread while the caller makes its data — the port's "compile".  With
``DMLC_TPU_BIN_BACKEND=cpu`` the bins are made on the host and only the
uint8 matrix goes to the device.

NaN-as-missing (XGBoost's learned default direction) switches on at the
first NaN of the training data: bin ``n_bins-1`` holds NaN, each node
learns a direction, the fused round is off (the unfused chain routes by
the direction: ``descend_kernel``'s direction mode, then B1) and the bin
levers are ignored, as in the JAX package.  ``fit(eval_set=,
early_stopping_rounds=, eval_every=)`` scores a validation set at chunk
ends and stops early.

Not ported: ranking objectives, ``predict_iter``, lossguide with NaN or
with monotone constraints (the JAX package refuses both too), external
memory, sharded ingest, one process over several GPUs.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ, LOG, log_fatal
from dmlc_core_tpu_torch.base.parameter import Parameter, field, get_env
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.models.gbt_objectives import (
    _METRICS_BY_OBJECTIVE, EVAL_METRIC_NAMES, EVAL_METRICS, OBJECTIVE_NAMES,
    OBJECTIVES, fold_scale_pos_weight)
from dmlc_core_tpu_torch.models.gbt_split import (_advance_node,
                                                  _host_bin_requested,
                                                  _host_bin_t,
                                                  _make_best_split, _maybe_l1,
                                                  gbt_metrics)
from dmlc_core_tpu_torch.utils import prng
from dmlc_core_tpu_torch.ops import binlayout as _bl
from dmlc_core_tpu_torch.ops.histogram import (build_histogram,
                                               dequantize_hist_sum,
                                               fused_descend_histogram,
                                               fused_round,
                                               hist_psum_bytes_per_round,
                                               hist_scales,
                                               quantize_hist_partial,
                                               sibling_pairs)
from dmlc_core_tpu_torch.ops.quantile import (apply_bins, apply_bins_missing,
                                              compute_cuts, xla_cumsum)
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import (Mesh, local_mesh,
                                               shard_row_ranges)
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["HistGBT", "HistGBTParam"]


def _grow_policy() -> str:
    """Tree growth policy (``DMLC_GROW_POLICY``): ``depthwise`` (default)
    or ``lossguide`` (LightGBM-style leaf-wise growth: expand the open
    leaf with the best gain, building ONE histogram per expansion +
    sibling subtraction)."""
    v = os.environ.get("DMLC_GROW_POLICY", "depthwise")
    CHECK(v in ("depthwise", "lossguide"),
          f"DMLC_GROW_POLICY must be 'depthwise' or 'lossguide', got {v!r}")
    return v


def _max_leaves() -> int:
    """``DMLC_MAX_LEAVES``: leaf budget for lossguide growth (0 = full
    2^max_depth, i.e. no budget beyond the depth cap)."""
    return get_env("DMLC_MAX_LEAVES", 0, int)


def _bin_pack_requested() -> bool:
    """``DMLC_BIN_PACK=1``: pack two ≤16-bin features per byte (int4) in
    the feature-major bin matrix (ops.binlayout).  Bit-identical
    histograms."""
    return os.environ.get("DMLC_BIN_PACK", "0") == "1"


def _feature_bundle_requested() -> bool:
    """``DMLC_FEATURE_BUNDLE=1``: fuse mutually-exclusive (near-one-hot)
    feature blocks into one multi-bin storage feature (EFB), with exact
    unbundling at split evaluation (ops.binlayout.detect_bundles)."""
    return os.environ.get("DMLC_FEATURE_BUNDLE", "0") == "1"


def _hist_blocks(data_size: int) -> int:
    """Resolved deterministic-histogram block count ``C`` (0 = off):
    ``DMLC_HIST_BLOCKS=N`` rounded up to a power of two ≥ the data-axis
    size, which must itself be a power of two — the JAX package's knob
    and checks.  The port's integer sums are order-free, so the blocks
    change no byte; the knob turns the fused round off, as in JAX."""
    v = get_env("DMLC_HIST_BLOCKS", 0, int)
    if v <= 0:
        return 0
    CHECK(data_size & (data_size - 1) == 0,
          f"DMLC_HIST_BLOCKS needs a power-of-two data-axis size, "
          f"got {data_size}")
    c = 1
    while c < max(v, data_size):
        c <<= 1
    return c


def _tree_fold(parts):
    """JAX's fixed-order pairwise fold of a power-of-two list of arrays,
    ``((p0+p1)+(p2+p3))+...``.  The training loop does not need it (int64
    sums fold alike in any order); kept, with its parity test, as the
    reference's deterministic reduction."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _fused_round_mode() -> str:
    """``DMLC_FUSED_ROUND``: the fused round kernel (``ops.histogram.
    fused_round``: descend, left children and the sibling subtraction in
    one call).  ``auto`` (default) and ``1`` use it wherever it is
    eligible — one rank, no ``DMLC_HIST_BLOCKS`` (its subtraction needs
    the synced parent) — ``0`` pins the unfused chain."""
    v = os.environ.get("DMLC_FUSED_ROUND", "auto")
    CHECK(v in ("auto", "0", "1"),
          f"DMLC_FUSED_ROUND must be 'auto', '0' or '1', got {v!r}")
    return v


def _fused_round_engaged(world: int) -> bool:
    """Whether a fit on a data axis of ``world`` ranks builds its levels
    with the fused round: one rank, no ``DMLC_HIST_BLOCKS``, and
    ``DMLC_FUSED_ROUND`` not ``0`` (the synced paths need the parent
    after the sync for their subtraction)."""
    return (world == 1 and not _hist_blocks(world)
            and _fused_round_mode() != "0")


def _rounds_schedule(n_trees: int, eval_every: int = 0) -> Tuple[int, int]:
    """(rounds per chunk K, remainder): ``DMLC_TPU_ROUNDS_PER_DISPATCH``
    (default 25) capped at ``n_trees`` and, with ``eval_every``, the
    largest divisor of ``eval_every`` not above that, so that chunk ends
    fall on eval rounds — the JAX package's schedule."""
    k_env = int(os.environ.get("DMLC_TPU_ROUNDS_PER_DISPATCH", 25))
    CHECK(k_env >= 1,
          f"DMLC_TPU_ROUNDS_PER_DISPATCH must be >= 1, got {k_env}")
    K = min(n_trees, k_env)
    if eval_every:
        K = max(d for d in range(1, K + 1) if eval_every % d == 0)
    return K, n_trees % K


class _KernelWarmup:
    """The port's compile step in the background: ``nvcc`` and the
    ``ctypes`` load of the CUDA sources a fit launches (``ops/_build.py``)
    on a thread, so that it overlaps the caller's datagen and binning.
    ``cache`` is ``"hit"`` when every library was built already,
    ``"miss"`` when this build makes one; ``seconds`` the thread's
    duration once it has ended."""

    #: the CUDA sources of the boosting loop's kernels
    SOURCES = ("histogram",)

    def __init__(self) -> None:
        from dmlc_core_tpu_torch.ops import _build

        self.cache = ("hit" if all(_build.is_built(n) for n in self.SOURCES)
                      else "miss")
        self.seconds: Optional[float] = None
        self._error: Optional[Exception] = None
        self._t0 = get_time()
        self._thread = threading.Thread(target=self._run,
                                        name="dmlc-kernel-warmup",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from dmlc_core_tpu_torch.ops._build import load_library

        try:
            for name in self.SOURCES:
                load_library(name)
        except Exception as e:  # noqa: BLE001 — re-raised by join()
            self._error = e
        finally:
            self.seconds = get_time() - self._t0

    def join(self) -> float:
        """Wait for the build; returns the seconds waited.  Raises what
        the build raised."""
        t0 = get_time()
        self._thread.join()
        if self._error is not None:
            raise self._error
        return get_time() - t0


def _fetch_trees(trees: List[Dict[str, torch.Tensor]]
                 ) -> List[Dict[str, np.ndarray]]:
    """A chunk's device trees as numpy arrays, in ONE copy to the host
    (int32 arrays travel as f32 bits), keys in sorted order as the JAX
    package's fetch gives them."""
    keys = tuple(sorted(trees[0]))
    parts, layout = [], []
    for t in trees:
        for k in keys:
            a = t[k].reshape(-1)
            layout.append((k, a.dtype == torch.int32, tuple(t[k].shape),
                           a.numel()))
            parts.append(a.view(torch.float32) if a.dtype == torch.int32
                         else a)
    flat = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for i, (k, is_int, shape, size) in enumerate(layout):
        if i % len(keys) == 0:
            out.append({})
        a = flat[off:off + size]
        out[-1][k] = (a.view(np.int32) if is_int else a).reshape(shape).copy()
        off += size
    return out


def _hist_quant_requested() -> bool:
    """``DMLC_HIST_QUANT=1``: int8-quantized histogram sync (per-rank
    int8 codes summed as int32, plus exact f32 column totals).
    Approximate; a no-op on one rank and under ``DMLC_HIST_BLOCKS``."""
    return os.environ.get("DMLC_HIST_QUANT", "0") == "1"


def _fused_descend_requested() -> bool:
    """``DMLC_TPU_FUSED_DESCEND=1``: where the fused round is off, each
    level's descend runs inside its histogram pass (the fused descend
    kernel) instead of as a torch pass before it.  Default off, as in
    the JAX package."""
    return os.environ.get("DMLC_TPU_FUSED_DESCEND", "0") == "1"


#: lossguide histogram pool limit (the JAX package's CHECK)
_POOL_LIMIT_BYTES = 256 << 20


class _HistSync:
    """How one fit's histograms become global over its mesh: which
    level engine runs (the fused round on one rank without missing mode,
    else the fused descend chain), and the syncs between accumulation
    and the subtraction."""

    def __init__(self, mesh: Mesh, n_global: int, missing: bool = False):
        self.mesh = mesh
        self.world = mesh.size
        self.n_global = n_global
        det_blocks = _hist_blocks(self.world)
        # missing mode's descend routes by the learned direction: the
        # unfused chain, as in JAX
        self.fused_rounds = (not missing
                             and _fused_round_engaged(self.world))
        self.quant = (_hist_quant_requested() and self.world > 1
                      and not det_blocks)
        self.fuse = _fused_descend_requested()
        synced = mesh.initialized and not self.fused_rounds
        #: the int64 all-reduce (``sync=`` of the histogram ops), or None
        self.acc_sync = self._sum if synced and not self.quant else None

    def _sum(self, acc: torch.Tensor) -> torch.Tensor:
        return coll.device_allreduce(acc, self.mesh)

    def _max(self, x: torch.Tensor) -> torch.Tensor:
        return coll.device_allreduce(x, self.mesh, op="max")

    def scales(self, g: torch.Tensor, h: torch.Tensor) -> Tuple[int, int]:
        """The tree's fixed-point scales from the global statistics."""
        if self.world == 1:
            return hist_scales(g, h)
        return hist_scales(g, h, self.n_global, self._max)

    def f32_sync(self, x: torch.Tensor) -> torch.Tensor:
        """A converted histogram after its sync: the int8 code sync of
        ``DMLC_HIST_QUANT`` (global column max, codes, exact totals), or
        the histogram itself (the int64 sums were synced already)."""
        if not self.quant:
            return x
        gmax = self._max(x.abs().amax(dim=-1, keepdim=True))
        q, scale, tot = quantize_hist_partial(x, gmax)
        qs = self._sum(q.to(torch.int32))
        return dequantize_hist_sum(qs, scale, self._sum(tot))

    def round_bytes(self, p: "HistGBTParam", n_features: int,
                    layout: Optional[_bl.BinLayout], grow_policy: str,
                    max_leaves: int) -> int:
        """Bytes one rank's syncs move per boosting round: int64 sums
        (twice the f32 model), or the int8 model under quant, for each of
        the round's ``num_class`` trees; 0 on one rank."""
        if self.world <= 1:
            return 0
        model = hist_psum_bytes_per_round(
            p.max_depth, n_features, p.n_bins, layout=layout,
            grow_policy=grow_policy, max_leaves=max_leaves,
            quant=self.quant) * max(p.num_class, 1)
        return model if self.quant else 2 * model


class HistGBTParam(Parameter):
    """Hyperparameters (XGBoost-compatible names where they exist) — the
    JAX package's fields, defaults and bounds, so ``to_dict()`` (and the
    saved payload) is the same dict."""

    n_trees = field(int, default=100, lower_bound=1, description="boosting rounds")
    max_depth = field(int, default=6, lower_bound=1, upper_bound=12)
    n_bins = field(int, default=256, lower_bound=2, upper_bound=256,
                   description="feature quantization bins (max_bin)")
    learning_rate = field(float, default=0.3, lower_bound=0.0, description="eta")
    reg_lambda = field(float, default=1.0, lower_bound=0.0, description="L2 on leaf weights")
    reg_alpha = field(float, default=0.0, lower_bound=0.0,
                      description="L1 on leaf weights (XGBoost alpha: "
                                  "soft-thresholded gradient sums)")
    gamma = field(float, default=0.0, lower_bound=0.0, description="min split gain")
    min_child_weight = field(float, default=1.0, lower_bound=0.0)
    objective = field(str, default="binary:logistic",
                      enum=list(OBJECTIVE_NAMES))
    max_group_size = field(int, default=0, lower_bound=0,
                           description="rank:pairwise — cap docs per "
                                       "query (0 = largest group; larger "
                                       "groups are truncated)")
    num_class = field(int, default=1, lower_bound=1,
                      description="classes for multi:softmax")
    base_score = field(float, default=0.0, description="initial raw margin")
    scale_pos_weight = field(float, default=1.0, lower_bound=0.0,
                             description="binary:logistic — weight "
                                         "multiplier for positive rows "
                                         "(imbalanced data; typical "
                                         "value: #neg/#pos)")
    subsample = field(float, default=1.0, lower_bound=0.0, upper_bound=1.0,
                      description="per-round row subsampling rate")
    colsample_bytree = field(float, default=1.0, lower_bound=0.0,
                             upper_bound=1.0,
                             description="per-tree feature sampling rate")
    seed = field(int, default=0, description="PRNG seed for sampling")
    eval_metric = field(str, default="",
                        enum=[""] + list(EVAL_METRIC_NAMES),
                        description="validation metric (default: the "
                                    "objective's own)")
    monotone_constraints = field(list, default=(),
                                 description="per-feature -1/0/+1 monotone "
                                             "constraints (empty = none)")
    hist_method = field(str, default="auto",
                        enum=["auto", "segment", "matmul", "pallas"],
                        description="histogram engine of the JAX package; "
                                    "this package has one (fixed-point "
                                    "sums) and keeps the field for model "
                                    "files")


#: the JAX package's tree-array key order (sorted, as its pytree fetch
#: returns them) — part of save_model's bytes
_TREE_KEYS = ("feat", "gain", "leaf", "thr")


class HistGBT:
    """Train/predict API on one device per process.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``; the CPU runs the
    plain PyTorch versions of the kernels.  With no GPU present the
    default raises rather than running on the CPU.  ``mesh`` is the data
    axis (default: the process group's, size 1 without one); on several
    ranks each process passes its own card as ``device``."""

    _MODEL_MAGIC = b"DCTGBT01"
    #: rows per device batch in predict (bounds the transient f32 X and
    #: bin matrices on the device)
    _PREDICT_BATCH = 2_000_000

    def __init__(self, param: Optional[HistGBTParam] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None, **kwargs: Any):
        self.param = param or HistGBTParam()
        if kwargs:
            self.param.init(kwargs)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh()
        #: the level engine and syncs of the fit in progress
        self._sync: Optional[_HistSync] = None
        # the field's bounds are inclusive; 0.0 would train degenerate
        # trees (XGBoost restricts both to (0, 1])
        CHECK(self.param.subsample > 0.0, "subsample must be in (0, 1]")
        CHECK(self.param.colsample_bytree > 0.0,
              "colsample_bytree must be in (0, 1]")
        if self.param.objective == "multi:softmax":
            CHECK(self.param.num_class >= 2,
                  "multi:softmax needs num_class >= 2")
        else:
            CHECK(self.param.num_class == 1,
                  f"num_class > 1 requires multi:softmax, "
                  f"got {self.param.objective!r}")
        if self.param.eval_metric:
            allowed = _METRICS_BY_OBJECTIVE[self.param.objective]
            CHECK(self.param.eval_metric in allowed,
                  f"eval_metric {self.param.eval_metric!r} incompatible "
                  f"with objective {self.param.objective!r} "
                  f"(allowed: {sorted(allowed)})")
        self._obj = self._objective()
        self.cuts: Optional[torch.Tensor] = None        # [F, n_bins-1] f32
        #: NaN-as-missing mode (XGBoost's learned default direction),
        #: entered at the first NaN of the training data: cuts
        #: ``[F, n_bins-2]``, bin ``n_bins-1`` reserved for NaN, trees
        #: with a per-node ``dir`` array (1 = missing rows go left).
        #: Sticky for the model's lifetime, and saved.
        self._missing = False
        self.trees: List[Dict[str, np.ndarray]] = []
        self.best_iteration: Optional[int] = None
        self.best_score: Optional[float] = None
        self._early_stopped = False
        #: the validation curve of the last ``eval_set`` fit: (round,
        #: score) at each chunk's end, and the metric's name
        self.eval_history: List[Tuple[int, float]] = []
        self.eval_metric_name: Optional[str] = None
        self.last_fit_seconds: Optional[float] = None
        #: (rounds fetched, seconds since the start of the boosting loop)
        #: as each chunk's trees arrive on the host: per-chunk timing
        #: evidence at no extra sync (the fetch is the chunk's one sync)
        self.last_chunk_times: List[Tuple[int, float]] = []
        #: per tree, its chunk's arrival time (per tree exactly with
        #: ``DMLC_TPU_ROUNDS_PER_DISPATCH=1``)
        self.last_tree_times: List[float] = []
        #: cold-start breakdown of the last fit: bin = cuts, binning and
        #: upload (make_device_data); compile = the kernel build thread's
        #: duration (start_warmup; None without it); warm_dispatch = the
        #: discarded warmup rounds' wall; warmup = the wait for the build
        #: thread + warm_dispatch; compile_cache = "hit" | "miss" | None
        self.last_bin_seconds: Optional[float] = None
        self.last_compile_seconds: Optional[float] = None
        self.last_warm_dispatch_seconds: Optional[float] = None
        self.last_warmup_seconds: Optional[float] = None
        #: {trace, dispatch, device} of warm_dispatch: trace = the wait for
        #: a pending start_warmup's kernel build and load (0 without one),
        #: dispatch = issuing the warmup rounds, device = waiting for them
        #: to finish
        self.last_warmup_breakdown: Optional[Dict[str, float]] = None
        self.last_compile_cache: Optional[str] = None
        self._pending_warmup: Optional[_KernelWarmup] = None
        self._train_preds: Optional[torch.Tensor] = None
        #: global rows of the last fit (train_margins' gather)
        self._train_rows = 0
        #: the storage layout of the last training matrix (None: plain)
        self._bin_layout: Optional[_bl.BinLayout] = None

    def _objective(self):
        p = self.param
        CHECK(p.objective in OBJECTIVES,
              f"objective {p.objective!r} is not ported to this package yet "
              f"(ported: {OBJECTIVES.list_all_names()})")
        return OBJECTIVES[p.objective]

    def _check_fit_data(self, n_features: int, y: np.ndarray) -> None:
        """:meth:`fit`'s checks of the labels against ``num_class`` and of
        ``monotone_constraints`` against the data's width (the JAX
        package's, with its messages)."""
        p = self.param
        if p.num_class > 1:
            CHECK(y.min() >= 0 and y.max() < p.num_class,
                  f"multi:softmax labels must be in [0, {p.num_class})")
        if p.monotone_constraints:
            CHECK_EQ(len(p.monotone_constraints), n_features,
                     "monotone_constraints length must equal n_features")
            # strict membership: 0.5 or "x" must be refused, not cast to
            # "no constraint" by int()
            CHECK(all(v in (-1, 0, 1) for v in p.monotone_constraints),
                  "monotone_constraints values must be -1, 0 or +1")

    def _mono_array(self, policy: str) -> Optional[np.ndarray]:
        """The ``[F]`` int32 monotone constraints, or None when none is
        set; refused with NaN, ``reg_alpha`` and lossguide, as the JAX
        package's round program refuses them."""
        p = self.param
        mono = None
        if p.monotone_constraints:
            mc = np.asarray([int(v) for v in p.monotone_constraints],
                            np.int32)
            if np.any(mc):
                mono = mc
        if self._missing:
            CHECK(mono is None,
                  "monotone_constraints with NaN features is not "
                  "supported (learned missing direction would need "
                  "direction-aware bound propagation) — impute missing "
                  "values or drop the constraints")
        if p.reg_alpha > 0.0:
            CHECK(mono is None,
                  "monotone_constraints with reg_alpha is not supported "
                  "(the constrained gain evaluation would need the L1 "
                  "term at the clipped weights) — drop one of the two")
        if policy == "lossguide":
            CHECK(not self._missing,
                  "DMLC_GROW_POLICY=lossguide with NaN/missing features "
                  "is not supported yet — impute, or use depthwise")
            CHECK(mono is None,
                  "DMLC_GROW_POLICY=lossguide with monotone_constraints "
                  "is not supported (bound propagation is level-order) "
                  "— use depthwise")
        return mono

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray,
            weight: Optional[np.ndarray] = None,
            cuts: Optional[torch.Tensor] = None, *,
            eval_set: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            early_stopping_rounds: int = 0,
            eval_every: int = 0) -> "HistGBT":
        """Boost ``n_trees`` rounds on ``X`` [n, F] / ``y`` [n]; bin cuts
        are computed from ``X`` unless ``cuts`` are given.  NaN in ``X``
        is missing (:attr:`_missing`).

        On a model that has trees (a fit, or :meth:`load_model`) this
        CONTINUES training, XGBoost's ``xgb_model``: the saved cuts bin
        ``X`` (the plain ``[F, n]`` matrix, no bin levers), the margins
        start from the ensemble's, replayed tree by tree, and the new
        trees are appended; round indices (sampling keys,
        ``eval_history``, ``best_iteration``) count the earlier trees.

        ``eval_set=(Xv, yv)`` scores the model at every chunk's end (the
        chunk size as :func:`_rounds_schedule` with ``eval_every``) by
        ``eval_metric``, or the objective's loss, into
        :attr:`eval_history`; ``best_iteration``/``best_score`` keep the
        best round, and with ``early_stopping_rounds`` boosting stops at
        the first chunk end that many rounds past it — then
        :meth:`predict` uses the trees up to ``best_iteration + 1``.  On
        several ranks every rank scores the whole eval set."""
        X = np.ascontiguousarray(X, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float32)
        CHECK_EQ(len(y), len(X), "X/y row mismatch")
        if early_stopping_rounds:
            CHECK(eval_set is not None,
                  "early_stopping_rounds needs an eval_set")
        self._check_fit_data(X.shape[1], y)
        # best_iteration indexes the FULL tree list
        n_prior = len(self.trees)
        if n_prior:
            # the trees' thresholds are bins of the saved cuts
            CHECK(self.cuts is not None, "continue-fit without cuts")
            self._check_nan_allowed(X, "fit (continued)")
            dd = self.make_device_data(X, y, weight=weight, levers=False)
            preds = self._apply_trees(dd["bins_t"], self.trees,
                                      self._base_margin(dd["n"]))
        else:
            self.cuts = None
            dd = self.make_device_data(X, y, weight=weight, cuts=cuts)
            preds = self._base_margin(dd["n"])
        after_chunk = None
        if eval_set is not None:
            after_chunk = self._eval_hook(eval_set, early_stopping_rounds,
                                          n_prior)
        return self._boost(dd, preds, n_prior, after_chunk=after_chunk,
                           eval_every=eval_every)

    def _eval_hook(self, eval_set: Tuple[np.ndarray, np.ndarray],
                   early_stopping_rounds: int, n_prior: int = 0
                   ) -> Callable[[int, List[Dict[str, torch.Tensor]]], bool]:
        """The eval set binned once (honouring missing mode), its margins
        on the device (the existing trees' first, on a continued fit), and
        the ``after_chunk`` hook of :meth:`_boost` that adds a chunk's
        trees to them, scores them and says whether to stop — the JAX
        package's validation state and logic, rounds counted from
        ``n_prior``."""
        p = self.param
        Xv = np.ascontiguousarray(eval_set[0], dtype=np.float32)
        yv = np.ascontiguousarray(eval_set[1], dtype=np.float32)
        CHECK_EQ(len(yv), len(Xv), "eval_set X/y row mismatch")
        self._check_nan_allowed(Xv, "eval_set")
        bins_v = self._bin_matrix(Xv)
        yv_d = torch.from_numpy(yv).to(self.device)
        if p.eval_metric:
            metric_fn, maximize = EVAL_METRICS[p.eval_metric]
            metric_name = p.eval_metric
        else:
            metric_fn, maximize = self._obj.eval_loss, False
            metric_name = "loss"
        self.best_iteration = None
        self.best_score = None
        self._early_stopped = bool(early_stopping_rounds)
        self.eval_history = []
        self.eval_metric_name = metric_name
        margin = self._base_margin(len(yv))
        if n_prior:
            margin = self._apply_trees(bins_v, self.trees, margin)
        state = {"best_at": 0, "margin": margin}

        def after_chunk(done: int, chunk) -> bool:
            st = {k: torch.stack([t[k] for t in chunk]) for k in chunk[0]}
            state["margin"] = self._apply_stacked(bins_v, st,
                                                  state["margin"])
            score = float(metric_fn(state["margin"], yv_d))
            self.eval_history.append((n_prior + done, score))
            improved = (self.best_score is None
                        or (score > self.best_score if maximize
                            else score < self.best_score))
            if improved:
                self.best_score = score
                self.best_iteration = n_prior + done - 1
                state["best_at"] = done
            elif (early_stopping_rounds
                  and done - state["best_at"] >= early_stopping_rounds):
                LOG("INFO", "early stop at round %d (best %s=%.5f @ %d)",
                    done, metric_name, self.best_score, state["best_at"])
                return True
            return False

        return after_chunk

    def _margin_shape(self, n: int) -> Tuple[int, ...]:
        """Margins are ``[n]``, ``[n, K]`` for ``multi:softmax``."""
        K = self.param.num_class
        return (n, K) if K > 1 else (n,)

    def _base_margin(self, n: int) -> torch.Tensor:
        """``base_score`` margins of ``n`` rows on the model's device."""
        return torch.full(self._margin_shape(n), self.param.base_score,
                          dtype=torch.float32, device=self.device)

    def _miss_bin(self) -> int:
        """The reserved NaN bin (``n_bins-1``, = #cuts + 1 by the cut
        width of missing mode), or -1 outside missing mode."""
        return int(self.cuts.shape[1]) + 1 if self._missing else -1

    def _bins_of(self, x: torch.Tensor) -> torch.Tensor:
        """Feature-major ``[F, n]`` bins of ``x`` [n, F] against the
        model's cuts, on ``x``'s device, honouring missing mode (NaN →
        bin ``n_bins-1``)."""
        if self._missing:
            return apply_bins_missing(x, self.cuts, self._miss_bin())
        return apply_bins(x, self.cuts)

    def _bin_matrix(self, X: np.ndarray) -> torch.Tensor:
        """:meth:`_bins_of` numpy ``X`` on the model's device, uploaded in
        batches of :attr:`_PREDICT_BATCH` rows."""
        parts = [self._bins_of(torch.from_numpy(
                     X[lo:lo + self._PREDICT_BATCH]).to(self.device))
                 for lo in range(0, max(len(X), 1), self._PREDICT_BATCH)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _check_nan_allowed(self, X: np.ndarray, where: str) -> None:
        """NaN given to a model not in missing mode fails loudly: plain
        binning would put NaN in the top value bin."""
        if not self._missing and np.isnan(X).any():
            log_fatal(f"{where}: X contains NaN but this model was "
                      f"trained without missing support (train with NaN "
                      f"present to enable the learned default "
                      f"direction, or impute)")

    def make_device_data(self, X: np.ndarray, y: np.ndarray,
                         weight: Optional[np.ndarray] = None,
                         cuts: Optional[torch.Tensor] = None, *,
                         levers: bool = True) -> Dict[str, Any]:
        """Quantise + upload a training set once, for repeated fits: cuts
        (computed where the data is binned, or ``cuts`` / the model's
        own), the feature-major uint8 ``[F, n]`` bin matrix — re-laid out
        to the physical ``[phys_rows, n]`` matrix when ``DMLC_BIN_PACK`` /
        ``DMLC_FEATURE_BUNDLE`` find a non-trivial layout (``"layout"``) —
        labels and weights on the device.  Sets ``self.cuts`` if unset.

        NaN is missing: the first NaN of a model without cuts enters
        missing mode (``n_bins >= 3``, every feature finite somewhere;
        cuts ``[F, n_bins-2]`` over the finite values, NaN in bin
        ``n_bins-1``, the bin levers ignored), which stays on for the
        model; NaN given to a model whose cuts were made without it
        raises.

        ``DMLC_TPU_BIN_BACKEND=cpu`` bins on the host
        (:func:`~dmlc_core_tpu_torch.models.gbt_split._host_bin_t`, the
        same bins as ``apply_bins``) and uploads only the uint8 matrix:
        no f32 ``X`` on the device.

        On a data axis of several ranks ``X``/``y`` are the GLOBAL rows
        (the same on every rank): cuts and the missing-mode decision come
        from all of them, the bins, labels and weights are this rank's
        ``mesh.row_range(n)``.  ``levers=False`` keeps the plain
        matrix whatever the bin levers say (a continued fit's)."""
        p = self.param
        t0 = get_time()
        X = np.ascontiguousarray(X, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float32)
        n, F = X.shape
        CHECK_EQ(len(y), n, "X/y row mismatch")
        # every rank holds the global X: the decision is global
        has_nan = bool(np.isnan(X).any())
        if has_nan and self.cuts is None and cuts is None:
            CHECK(p.n_bins >= 3,
                  "NaN features need n_bins >= 3 (one bin is reserved "
                  "for missing)")
            CHECK(bool(np.isfinite(X).any(axis=0).all()),
                  "a feature is all-NaN: drop it or impute")
            self._missing = True
        else:
            CHECK(not has_nan or self._missing,
                  "X contains NaN but this model's bins were built "
                  "without a missing bin — refit from scratch (NaN in "
                  "the first fit enables missing support) or impute")
        missing = self._missing
        weight = fold_scale_pos_weight(p, y, weight)
        host = _host_bin_requested()
        lo, hi = self.mesh.row_range(n)
        w = (None if weight is None else
             torch.from_numpy(np.ascontiguousarray(weight, np.float32)))
        X_d = None if host else torch.from_numpy(X).to(self.device)
        # missing mode: n_bins-1 value bins, bin n_bins-1 for NaN
        cut_bins = p.n_bins - 1 if missing else p.n_bins
        if cuts is not None:
            self.cuts = torch.as_tensor(cuts, dtype=torch.float32,
                                        device=self.device)
        elif self.cuts is None:
            if host:
                self.cuts = compute_cuts(torch.from_numpy(X), cut_bins,
                                         weight=w, missing=missing
                                         ).to(self.device)
            else:
                self.cuts = compute_cuts(
                    X_d, cut_bins,
                    weight=None if w is None else w.to(self.device),
                    missing=missing)
        # the mode's invariant: a wrong width would move the NaN bin
        CHECK_EQ(int(self.cuts.shape[1]), cut_bins - 1,
                 f"cuts width must be n_bins-{2 if missing else 1} for this "
                 f"model ({'missing' if missing else 'standard'} mode)")
        cuts_np = self.cuts.cpu().numpy() if host else None

        def binned(a: int, b: int) -> torch.Tensor:
            if host:
                return torch.from_numpy(_host_bin_t(X[a:b], cuts_np,
                                                    missing=missing))
            return self._bins_of(X_d[a:b])

        bins_t = binned(lo, hi).to(self.device)
        layout = None
        levers = levers and (_bin_pack_requested()
                             or _feature_bundle_requested())
        if levers and missing:
            LOG("WARNING", "DMLC_BIN_PACK/DMLC_FEATURE_BUNDLE ignored: "
                "missing mode (the reserved NaN bin pins every feature "
                "at full width)")
        elif levers:
            # bundles are proposed on the first 65536 global rows, as the
            # JAX package samples
            sample = (binned(0, min(n, 1 << 16)).cpu().numpy()
                      if _feature_bundle_requested() else None)
            layout = self._compute_bin_layout(bins_t, F, sample)
            if layout is not None:
                bins_t = _bl.pack_matrix(bins_t, layout)
        del X_d
        self._bin_layout = layout
        dd = {
            "bins_t": bins_t,
            "y_d": torch.from_numpy(y[lo:hi]).to(self.device),
            "w_d": (torch.ones(hi - lo, dtype=torch.float32,
                               device=self.device)
                    if w is None else w[lo:hi].contiguous().to(self.device)),
            "n": hi - lo,
            "n_global": n,
            "n_features": F,
            "layout": layout,
        }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_bin_seconds = get_time() - t0
        return dd

    def start_warmup(self, n_rows: int, n_features: int) -> bool:
        """Start building and loading the boosting loop's CUDA kernels on
        a thread, before the training data exists (the bench's cold-start
        overlap: the build runs while datagen and binning do).  The next
        :meth:`fit_device` joins it and reports it as
        ``last_compile_seconds`` / ``last_compile_cache``; without it the
        first round builds the kernels.  The build does not depend on the
        data's shape: ``n_rows``/``n_features`` only mirror the JAX
        signature.  Returns False on the CPU (nothing to build) or when a
        warmup is already pending."""
        del n_rows, n_features
        if self.device.type != "cuda" or self._pending_warmup is not None:
            return False
        self._pending_warmup = _KernelWarmup()
        return True

    def _compute_bin_layout(self, bins_t: torch.Tensor, n_features: int,
                            sample: Optional[np.ndarray]
                            ) -> Optional[_bl.BinLayout]:
        """The packed/bundled storage layout of a binned ``[F, n]``
        matrix (``DMLC_BIN_PACK`` / ``DMLC_FEATURE_BUNDLE``), or None.

        Occupancy counts come from the binned rows (the cuts cannot say
        how many bins a feature really uses), summed over the ranks.
        Bundles are proposed on ``sample``, the ``[F, m]`` bins of the
        first ``min(n, 65536)`` global rows, as the JAX package samples,
        and each is verified exactly on every rank's matrix before it is
        kept — every rank derives the 1-rank fit's layout."""
        p = self.param
        counts = _bl.bin_counts(bins_t, p.n_bins)
        if self.mesh.size > 1:
            counts = coll.device_allreduce(
                torch.from_numpy(counts.astype(np.int64)).to(self.device),
                self.mesh).cpu().numpy().astype(np.int32)
        bundles: tuple = ()
        if _feature_bundle_requested():
            proposed = _bl.detect_bundles(sample, counts, p.n_bins)
            dflt = _bl.default_bins(counts)
            bundles = tuple(b for b in proposed
                            if self._bundle_exclusive(bins_t, b, dflt))
            if len(proposed) != len(bundles):
                LOG("INFO", "feature bundling: %d/%d sampled bundles "
                    "survived exact full-data verification",
                    len(bundles), len(proposed))
        layout = _bl.compute_layout(counts, n_features, p.n_bins,
                                    pack=_bin_pack_requested(),
                                    bundles=bundles)
        if layout is not None:
            LOG("INFO", "bin layout: %d features -> %d physical rows "
                "(%d int4 pairs, %d bundles; %d/%d sync bins)",
                n_features, layout.phys_rows, len(layout.pairs),
                sum(1 for mm in layout.members if len(mm) > 1),
                layout.sync_bins, p.n_bins)
        return layout

    def _bundle_exclusive(self, bins_t: torch.Tensor, bundle,
                          defaults) -> bool:
        """Exact mutual-exclusivity check of one proposed bundle over the
        full matrix (every rank's rows): no row may have two members off
        their DEFAULT bin."""
        nz = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                         device=bins_t.device)
        for f in bundle:
            nz += (bins_t[int(f)] != int(defaults[int(f)])).to(torch.int32)
        worst = nz.max(dim=0, keepdim=True).values if nz.numel() else (
            torch.zeros(1, dtype=torch.int32, device=nz.device))
        if self.mesh.size > 1:
            worst = coll.device_allreduce(worst, self.mesh, op="max")
        return int(worst) <= 1

    def _lossguide_leaves(self, n_features: int) -> int:
        """The leaf budget of a lossguide tree, with the JAX package's
        checks: at least 2 leaves, the histogram pool at most 256 MB."""
        p = self.param
        n_leaf = 1 << p.max_depth
        max_leaves = _max_leaves()
        CHECK(max_leaves >= 0, "DMLC_MAX_LEAVES must be >= 0")
        leaves = min(max_leaves, n_leaf) if max_leaves else n_leaf
        CHECK(leaves >= 2,
              f"lossguide needs >= 2 leaves (max_depth={p.max_depth}, "
              f"DMLC_MAX_LEAVES={max_leaves})")
        CHECK(leaves * 2 * n_features * p.n_bins * 4 <= _POOL_LIMIT_BYTES,
              f"lossguide histogram pool would exceed 256 MB "
              f"({leaves} leaves x {n_features} features x {p.n_bins} "
              f"bins) — lower DMLC_MAX_LEAVES or max_depth")
        return leaves

    def fit_device(self, dd: Dict[str, Any], warmup_rounds: int = 0,
                   chunk_callback: Optional[Callable[[int, float], Any]]
                   = None,
                   after_chunk: Optional[Callable[..., bool]] = None,
                   eval_every: int = 0, resume: bool = False) -> "HistGBT":
        """Boost ``n_trees`` rounds over a :meth:`make_device_data`
        handle — the repeated-fit path, no re-upload and no re-binning.
        A new fit (the trees of an earlier one are dropped) unless
        ``resume=True``, which CONTINUES from the existing trees: the
        margins are the carried training margins when they fit the handle
        (bit-identical to a replay), else the ensemble replayed on the
        handle's bins, and the global round index is threaded through so
        that sampling draws what an uninterrupted fit draws.  The growth
        policy is read from ``DMLC_GROW_POLICY`` here.

        Rounds run in chunks of ``DMLC_TPU_ROUNDS_PER_DISPATCH``: a
        chunk's trees stay on the device and come to the host in one
        fetch, at which ``last_chunk_times`` takes ``(rounds fetched,
        seconds)`` and ``chunk_callback(rounds_fetched, elapsed_s)``
        fires.  Any chunk size gives the same trees, save under sampling:
        the draws follow the chunks (a chunk's key folds in the round it
        starts at), as in the JAX package.  ``warmup_rounds`` discarded
        rounds run first on a copy of the margins (the first use of every
        kernel and op), after joining a pending :meth:`start_warmup`; the
        model is untouched by them and the timed fit
        (``last_fit_seconds``) leaves them out.

        ``after_chunk(rounds_done, chunk_trees)`` — :meth:`fit`'s eval
        set — runs after each chunk's fetch with the chunk's trees still
        on the device, and ends boosting when it returns True; without it
        the early-stopping state is reset.  ``eval_every`` makes chunk
        ends fall on its multiples (:func:`_rounds_schedule`) and logs
        this rank's training loss there."""
        if resume and self.trees:
            CHECK(self.cuts is not None, "resume-fit without cuts")
            n_prior = len(self.trees)
            preds = self._resume_margin(dd)
        else:
            self.trees = []
            n_prior = 0
            preds = self._base_margin(dd["n"])
        return self._boost(dd, preds, n_prior, warmup_rounds=warmup_rounds,
                           chunk_callback=chunk_callback,
                           after_chunk=after_chunk, eval_every=eval_every)

    def _resume_margin(self, dd: Dict[str, Any]) -> torch.Tensor:
        """Margins of the existing ensemble over the handle's rows: the
        carried training margins of the previous fit when their shape is
        the handle's (no work), else the trees replayed on the handle's
        bins — bit-identical, the replay adding the same leaf values in
        the order the rounds added them.  A packed or bundled handle
        cannot be replayed (the descend reads the plain matrix)."""
        carried = self._train_preds
        if (carried is not None
                and tuple(carried.shape) == self._margin_shape(dd["n"])):
            return carried
        CHECK(dd.get("layout") is None,
              "resume-fit margin replay on a packed/bundled handle needs "
              "the carried training margins (a restored process has "
              "none) — refit, or make the handle with DMLC_BIN_PACK=0 "
              "and DMLC_FEATURE_BUNDLE=0")
        return self._apply_trees(dd["bins_t"], self.trees,
                                 self._base_margin(dd["n"]))

    def _boost(self, dd: Dict[str, Any], preds: torch.Tensor, n_prior: int,
               warmup_rounds: int = 0,
               chunk_callback: Optional[Callable[[int, float], Any]] = None,
               after_chunk: Optional[Callable[..., bool]] = None,
               eval_every: int = 0) -> "HistGBT":
        """The boosting loop of :meth:`fit` and :meth:`fit_device`: append
        ``n_trees`` rounds' trees to :attr:`trees`, starting from the
        margins ``preds``, ``n_prior`` rounds into the model."""
        CHECK(warmup_rounds >= 0, "warmup_rounds must be >= 0")
        p = self.param
        bins_t, y_d, w_d = dd["bins_t"], dd["y_d"], dd["w_d"]
        layout = dd.get("layout")
        self._bin_layout = layout
        CHECK(bins_t.dtype == torch.uint8, "n_bins > 256 is not supported")
        F = dd["n_features"]
        self._sync = _HistSync(self.mesh, dd.get("n_global", dd["n"]),
                               self._missing)
        policy = _grow_policy()
        mono = self._mono_array(policy)
        if mono is not None:
            CHECK_EQ(len(mono), F,
                     "monotone_constraints length must equal n_features")
        sync_bytes = self._sync.round_bytes(p, F, layout, policy,
                                            _max_leaves())
        if after_chunk is None:
            self.best_iteration = self.best_score = None
            self._early_stopped = False
            self.eval_history = []
            self.eval_metric_name = None
        if policy == "lossguide":
            leaves = self._lossguide_leaves(F)
            heap = _heap_tables(p.max_depth, self.device)

            def grow(g, h, feat_mask):
                return self._grow_tree_lossguide(bins_t, g, h, layout,
                                                 leaves, heap, feat_mask)
        else:
            def grow(g, h, feat_mask):
                return self._grow_tree(bins_t, g, h, layout, feat_mask,
                                       mono)

        sampling = p.subsample < 1.0 or p.colsample_bytree < 1.0
        base_key = prng.key(p.seed) if sampling else None
        n_class = p.num_class

        def boost(preds, key=None):
            keep = feat_mask = None
            if key is not None:
                keep, feat_mask = self._sample_masks(key, dd["n"], F)
            g, h = self._obj.grad_hess(preds, y_d)
            if n_class <= 1:
                g, h = g * w_d, h * w_d
                if keep is not None:
                    g = torch.where(keep, g, 0.0)
                    h = torch.where(keep, h, 0.0)
                tree, delta = grow(g, h, feat_mask)
                return tree, preds + delta
            # K trees a round, one per class, on the full-softmax
            # gradients' columns (XGBoost multi:softmax)
            g, h = g * w_d[:, None], h * w_d[:, None]
            if keep is not None:                      # same rows ∀ class
                g = torch.where(keep[:, None], g, 0.0)
                h = torch.where(keep[:, None], h, 0.0)
            trees, deltas = [], []
            for c in range(n_class):
                tree_c, delta_c = grow(g[:, c].contiguous(),
                                       h[:, c].contiguous(), feat_mask)
                trees.append(tree_c)
                deltas.append(delta_c)
            tree = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
            return tree, preds + torch.stack(deltas, dim=1)

        def chunk_keys(start: int, k: int):
            """The round keys of a chunk of ``k`` rounds from global
            round ``start`` (the JAX package's scan of splits)."""
            if not sampling:
                return [None] * k
            key_c, out = prng.fold_in(base_key, start), []
            for _ in range(k):
                key_c, key_r = prng.split(key_c)
                out.append(key_r)
            return out

        self._warmup(boost, preds, chunk_keys(n_prior, warmup_rounds))
        K, rem = _rounds_schedule(p.n_trees, eval_every)
        report = _metrics.enabled()
        m = gbt_metrics() if report else None
        self.last_chunk_times = []
        self.last_tree_times = []
        t0 = get_time()
        done = 0
        while done < p.n_trees:
            k = K if p.n_trees - done >= K else rem
            chunk = []
            for key in chunk_keys(n_prior + done, k):
                tree, preds = boost(preds, key)
                chunk.append(tree)
            self.trees.extend(_fetch_trees(chunk))    # the chunk's one sync
            done += k
            prev_t = self.last_chunk_times[-1][1] if done > k else 0.0
            self.last_chunk_times.append((done, get_time() - t0))
            self.last_tree_times.extend([self.last_chunk_times[-1][1]] * k)
            coll.record_hist_psum(k * sync_bytes)
            if report:
                m["phase"].observe(
                    (self.last_chunk_times[-1][1] - prev_t) / k,
                    engine="incore", phase="round")
                m["rounds"].inc(k, engine="incore")
                m["trees"].inc(k, engine="incore")
            if chunk_callback is not None:
                chunk_callback(*self.last_chunk_times[-1])
            if eval_every and done % eval_every == 0:
                LOG("INFO", "round %d: loss=%.5f", done,
                    float(self._obj.metric(preds, y_d)))
            if after_chunk is not None and after_chunk(done, chunk):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_fit_seconds = get_time() - t0
        self._train_preds = preds
        self._train_rows = dd.get("n_global", dd["n"])
        return self

    def _sample_masks(self, key: torch.Tensor, n: int, n_features: int
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
        """One round's (row keep mask | None, feature mask | None) — the
        JAX package's ``sample_masks``: rows draw ``uniform(fold_in(
        key_rows, rank), [n]) < subsample`` (element i's draw depends on i
        alone, so this rank's unpadded rows draw what JAX's padded shard
        draws); features keep the ``ceil(c·F)`` smallest of ``uniform(
        key_cols, [F])``, the same on every rank."""
        p = self.param
        keep = feat_mask = None
        key_rows, key_cols = prng.split(key)
        if p.subsample < 1.0:
            key_rows = prng.fold_in(key_rows, self.mesh.rank)
            u = prng.uniform(key_rows, (n,), self.device)
            keep = u < torch.tensor(p.subsample, dtype=torch.float32,
                                    device=self.device)
        if p.colsample_bytree < 1.0:
            n_keep = max(1, int(math.ceil(p.colsample_bytree * n_features)))
            scores = prng.uniform(key_cols, (n_features,), self.device)
            kth = torch.sort(scores).values[n_keep - 1]
            feat_mask = scores <= kth
        return keep, feat_mask

    def _warmup(self, boost, preds: torch.Tensor, keys: List) -> None:
        """Join a pending :meth:`start_warmup`, then run one discarded
        round of ``boost`` per entry of ``keys`` (its sampling key, or
        None) on a copy of ``preds``; sets the ``last_warmup_*`` /
        ``last_compile_*`` attributes."""
        rounds = len(keys)
        warm, self._pending_warmup = self._pending_warmup, None
        join_wait = 0.0
        self.last_compile_seconds = self.last_compile_cache = None
        if warm is not None:
            join_wait = warm.join()
            self.last_compile_seconds = warm.seconds
            self.last_compile_cache = warm.cache
        t_w = get_time()
        dispatch_s = device_s = 0.0
        if rounds > 0:
            t_d = get_time()
            wp = preds.clone()
            for key in keys:
                _, wp = boost(wp, key)
            dispatch_s = get_time() - t_d
            t_v = get_time()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            device_s = get_time() - t_v
        self.last_warm_dispatch_seconds = get_time() - t_w
        self.last_warmup_seconds = join_wait + self.last_warm_dispatch_seconds
        # "trace": the wait for the kernels' build, the port's compile
        self.last_warmup_breakdown = {"trace": round(join_wait, 6),
                                      "dispatch": round(dispatch_s, 6),
                                      "device": round(device_s, 6)}
        if _metrics.enabled() and rounds > 0:
            gbt_metrics()["phase"].observe(self.last_warmup_seconds,
                                           engine="incore", phase="warmup")

    def _grow_tree(self, bins_t: torch.Tensor, g: torch.Tensor,
                   h: torch.Tensor, layout: Optional[_bl.BinLayout] = None,
                   feat_mask: Optional[torch.Tensor] = None,
                   mono: Optional[np.ndarray] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One depth-wise tree on (g, h) → (tree arrays, margin delta).

        Level 0 builds the root histogram over all rows; every deeper
        level is one fused round: rows descend by the level above's split
        tables, only LEFT children get a built histogram, the right child
        is parent − left.  Where the fused round is off (data parallel,
        ``DMLC_HIST_BLOCKS``, ``DMLC_FUSED_ROUND=0``, missing mode) a level
        is the fused descend, the sync of the left children, then the
        subtraction.  In missing mode each level also learns ``dir``, and
        the descends route NaN rows by it (``descend_kernel``'s direction
        mode on the card).
        All levels share one fixed-point scale pair, so every histogram's
        bytes are independent of summation order.  Under a ``layout``
        histograms and the subtraction stay in storage space; split
        scoring sees them unbundled.  ``feat_mask`` [F] bool (column
        sampling) limits every node's choice to its features.

        With ``mono`` ([F] in {-1, 0, +1}) every level scores with the
        child sums and the nodes' weight bounds (``[-inf, inf]`` at the
        root), then bounds its children: on a real split (``thr < B-1``)
        of a constrained feature the midpoint of the two clipped child
        weights caps one child and floors the other; leaves are clipped
        into their bounds — the JAX package's propagation."""
        p = self.param
        depth, B = p.max_depth, p.n_bins
        lam, alpha = p.reg_lambda, p.reg_alpha
        half = max((1 << depth) >> 1, 1)
        missing = self._missing
        miss_bin = B - 1 if missing else None
        split = _make_best_split(B, lam, p.gamma, p.min_child_weight,
                                 alpha=alpha, missing=missing, mono=mono)
        split_leaf = _make_best_split(B, lam, p.gamma, p.min_child_weight,
                                      with_child_sums=True, alpha=alpha,
                                      missing=missing, mono=mono)
        dev = bins_t.device
        bounds = None
        if mono is not None:
            mono_t = torch.from_numpy(mono).to(dev)
            bounds = torch.tensor([[float("-inf"), float("inf")]],
                                  dtype=torch.float32, device=dev)

        sync = self._sync
        scales = sync.scales(g, h)
        node = torch.zeros(bins_t.shape[1], dtype=torch.int32, device=dev)
        feats, thrs, gains, dirs = [], [], [], []
        prev_hist = feat = thr = dirv = gsum = hsum = None
        for level in range(depth):
            n_nodes = 1 << level
            want_sums = mono is not None or level == depth - 1

            def score_fn(hs, _w=want_sums, _b=bounds):
                ev = _bl.unbundle_hist(hs, layout, B)
                if _w:
                    return split_leaf(ev, feat_mask, _b)
                return split(ev, feat_mask)

            if level == 0:
                hist = sync.f32_sync(build_histogram(
                    bins_t, node, g, h, 1, B, scales=scales, layout=layout,
                    sync=sync.acc_sync))
                scores = score_fn(hist)
            elif sync.fused_rounds:
                node, hist, scores = fused_round(
                    bins_t, node, feat, thr, g, h, prev_hist, n_nodes >> 1,
                    B, score_fn=score_fn, by_node=True, scales=scales,
                    layout=layout)
            else:
                left, node = fused_descend_histogram(
                    bins_t, node, feat, thr, g, h, n_nodes >> 1, B,
                    fuse=sync.fuse, dir_sel=dirv, miss_bin=miss_bin,
                    layout=layout, by_node=True, scales=scales,
                    sync=sync.acc_sync)
                hist = sibling_pairs(sync.f32_sync(left), prev_hist)
                scores = score_fn(hist)
            prev_hist = hist
            if missing:
                feat, thr, dirv, gn = scores[:4]
            else:
                feat, thr, gn = scores[:3]
            if want_sums:
                gsum, hsum = scores[-2:]
            pad = half - n_nodes
            feats.append(torch.nn.functional.pad(feat, (0, pad)))
            thrs.append(torch.nn.functional.pad(thr, (0, pad)))
            gains.append(torch.nn.functional.pad(gn, (0, pad)))
            if missing:
                dirs.append(torch.nn.functional.pad(dirv, (0, pad)))
            if mono is not None:
                bounds = _child_bounds(bounds, gsum, hsum, lam, mono_t,
                                       feat, thr, B)
        # final descend into the leaf layer
        leaf_node = _advance_node(bins_t, node, feat, thr, layout, dirv,
                                  miss_bin)
        leaf_w = -_maybe_l1(gsum, alpha) / (hsum + lam)
        if mono is not None:
            leaf_w = torch.minimum(torch.maximum(leaf_w, bounds[:, 0]),
                                   bounds[:, 1])
        leaf = leaf_w * p.learning_rate
        tree = {"feat": torch.stack(feats), "thr": torch.stack(thrs),
                "gain": torch.stack(gains), "leaf": leaf}
        if missing:
            tree["dir"] = torch.stack(dirs)
        return tree, leaf[leaf_node]

    def _grow_tree_lossguide(self, bins_t: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor,
                             layout: Optional[_bl.BinLayout], n_leaves: int,
                             heap: Tuple[torch.Tensor, torch.Tensor],
                             feat_mask: Optional[torch.Tensor] = None
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        torch.Tensor]:
        """One LEAF-WISE tree on (g, h) → (tree arrays, margin delta).

        LightGBM lossguide, as the JAX package grows it: a gain-priority
        queue over open leaves (heap ids: root 1, children 2i / 2i+1); each
        of the ``n_leaves − 1`` expansions splits the open leaf with the
        best candidate gain (first maximum), builds ONE histogram — the
        left child over that leaf's rows — and derives the right child
        from the parent's pooled histogram, both in one ``fused_round``
        at ``n_prev=1`` (where the fused round is off: the fused descend,
        the sync, then the subtraction).  An expansion whose best gain is
        not above ``gamma`` changes nothing (the ``ok`` gate).

        The queue lives on the device and every update is a masked
        tensor op (writes that the gate cancels go to spare entries past
        the end), so the loop launches all ``n_leaves − 1`` expansions
        without a host sync, as the JAX ``scan`` does.  Trees come out in
        depth-wise's complete-tree arrays: unexpanded slots carry feat 0,
        thr B−1, gain 0, leaf −0.0."""
        p = self.param
        depth, B = p.max_depth, p.n_bins
        lam, alpha, gamma = p.reg_lambda, p.reg_alpha, p.gamma
        dev = bins_t.device
        n = bins_t.shape[1]
        n_leaf = 1 << depth
        half = max(n_leaf >> 1, 1)
        NH = 1 << (depth + 1)
        L = n_leaves
        levels, poss = heap
        split = _make_best_split(B, lam, gamma, p.min_child_weight,
                                 alpha=alpha)
        sync = self._sync
        scales = sync.scales(g, h)

        def eval_nodes(hist_st):
            """(feat, thr, gain, tot_g, tot_h) per node of a storage-space
            histogram stack [2, N, S, Bs]."""
            ev = _bl.unbundle_hist(hist_st, layout, B)
            f_, t_, gn_ = split(ev, feat_mask)
            tot = xla_cumsum(ev[:, :, :1])[..., 0, -1]        # [2, N]
            return f_, t_, gn_, tot[0], tot[1]

        i32, f32 = torch.int32, torch.float32
        # ---- root ----
        node = torch.ones(n, dtype=i32, device=dev)          # heap ids
        root = sync.f32_sync(build_histogram(
            bins_t, torch.zeros(n, dtype=i32, device=dev), g, h, 1, B,
            scales=scales, layout=layout, sync=sync.acc_sync))
        f0, t0, g0, tg0, th0 = eval_nodes(root)
        # per heap id, plus two spare entries (NH, NH+1) for cancelled writes
        open_ = torch.zeros(NH + 2, dtype=torch.bool, device=dev)
        open_[1] = True
        leaf_g = torch.zeros(NH + 2, dtype=f32, device=dev)
        leaf_h = torch.zeros(NH + 2, dtype=f32, device=dev)
        leaf_g[1:2] = tg0
        leaf_h[1:2] = th0
        cand_feat = torch.zeros(NH + 2, dtype=i32, device=dev)
        cand_thr = torch.full((NH + 2,), B - 1, dtype=i32, device=dev)
        cand_gain = torch.full((NH + 2,), float("-inf"), dtype=f32,
                               device=dev)
        cand_feat[1:2] = f0
        cand_thr[1:2] = t0
        cand_gain[1:2] = g0
        rec_feat = torch.zeros(NH + 2, dtype=i32, device=dev)
        rec_thr = torch.full((NH + 2,), B - 1, dtype=i32, device=dev)
        rec_gain = torch.zeros(NH + 2, dtype=f32, device=dev)
        # histogram pool of the open leaves, storage space, + 2 spare slots
        pool = torch.zeros((L + 2, 2) + tuple(root.shape[2:]), dtype=f32,
                           device=dev)
        pool[0] = root[:, 0]
        pool_id = torch.zeros(L + 2, dtype=i32, device=dev)
        pool_id[0] = 1
        can_grow = levels < depth                               # [NH]

        for _ in range(L - 1):
            gains = torch.where(open_[:NH] & can_grow, cand_gain[:NH],
                                float("-inf"))
            hc = torch.argmax(gains).view(1)                    # int64 [1]
            ok = gains.index_select(0, hc) > gamma              # [1]
            fsel = cand_feat.index_select(0, hc)
            tsel = cand_thr.index_select(0, hc)
            hc_eff = torch.where(ok, hc, NH)
            rec_feat.index_copy_(0, hc_eff, fsel)
            rec_thr.index_copy_(0, hc_eff, tsel)
            rec_gain.index_copy_(0, hc_eff, cand_gain.index_select(0, hc))
            take = ok & (node == hc)                            # [n]
            slot = torch.argmax((pool_id[:L] == hc).to(i32)).view(1)
            # one fused round: descend the leaf's rows, build the left
            # child, subtract it from the pooled parent
            node_in = torch.where(take, 0, -1).to(i32)
            parent = pool.index_select(0, slot).transpose(0, 1)
            if sync.fused_rounds:
                nn, pair, sc2 = fused_round(
                    bins_t, node_in, fsel, tsel, g, h, parent, 1, B,
                    score_fn=eval_nodes, by_node=True, scales=scales,
                    layout=layout)
            else:
                left, nn = fused_descend_histogram(
                    bins_t, node_in, fsel, tsel, g, h, 1, B, fuse=sync.fuse,
                    layout=layout, by_node=True, scales=scales,
                    sync=sync.acc_sync)
                pair = sibling_pairs(sync.f32_sync(left), parent)
                sc2 = eval_nodes(pair)
            node = torch.where(take, 2 * node + (nn == 1).to(i32), node)
            f2, t2, g2, tg2, th2 = sc2
            # children at the depth cap never expand
            child_lvl = levels.index_select(0, (2 * hc).clamp(max=NH - 1))
            g2 = torch.where(child_lvl < depth, g2, float("-inf"))
            kids = torch.cat([torch.where(ok, 2 * hc, NH),
                              torch.where(ok, 2 * hc + 1, NH + 1)])
            open_.index_fill_(0, hc_eff, False)
            open_.index_fill_(0, kids, True)
            leaf_g.index_copy_(0, kids, tg2)
            leaf_h.index_copy_(0, kids, th2)
            cand_feat.index_copy_(0, kids, f2)
            cand_thr.index_copy_(0, kids, t2)
            cand_gain.index_copy_(0, kids, g2)
            # pool: the parent's slot takes the left child, the first free
            # slot (searched before that overwrite) the right
            free = torch.argmax((pool_id[:L] == 0).to(i32)).view(1)
            slots = torch.cat([torch.where(ok, slot, L),
                               torch.where(ok, free, L + 1)])
            pool.index_copy_(0, slots, pair.transpose(0, 1))
            pool_id.index_copy_(0, slots, torch.cat([2 * hc, 2 * hc + 1]
                                                    ).to(i32))

        # leaf table in depth-wise's positional layout: every position an
        # open leaf does not own is an empty leaf, exactly −0.0
        is_open = open_[:NH]
        w_all = (-_maybe_l1(leaf_g[:NH], alpha) / (leaf_h[:NH] + lam)
                 ) * p.learning_rate
        spare = n_leaf + torch.arange(NH, device=dev)
        pos = torch.where(is_open, poss, spare)
        leaf = torch.full((n_leaf + NH,), -0.0, dtype=f32, device=dev)
        leaf.index_copy_(0, pos, w_all)
        leaf = leaf[:n_leaf]

        def per_level(a):
            return torch.stack([
                torch.nn.functional.pad(a[1 << lv:1 << (lv + 1)],
                                        (0, half - (1 << lv)))
                for lv in range(depth)])

        tree = {"feat": per_level(rec_feat), "thr": per_level(rec_thr),
                "gain": per_level(rec_gain), "leaf": leaf}
        delta = torch.where(is_open, w_all, 0.0)[node.to(torch.int64)]
        return tree, delta

    def train_margins(self) -> np.ndarray:
        """Raw training-set margins after :meth:`fit`, of all global rows
        in their order (on several ranks: gathered from every rank)."""
        CHECK(self._train_preds is not None, "call fit first")
        preds = self._train_preds
        world = self.mesh.size
        if world == 1:
            return preds.cpu().numpy()
        ranges = shard_row_ranges(self._train_rows, world)
        width = max(hi - lo for lo, hi in ranges)
        pad = (0, 0) * (preds.dim() - 1) + (0, width - preds.shape[0])
        padded = torch.nn.functional.pad(preds, pad)
        gathered = coll.device_allgather(padded, self.mesh).cpu()
        return torch.cat([gathered[r * width:r * width + hi - lo]
                          for r, (lo, hi) in enumerate(ranges)]).numpy()

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _resolve_trees(self, n_trees: Optional[int]):
        """Trees used for prediction: explicit count, else the early-stop
        winner of a loaded model, else all."""
        if (n_trees is None and self._early_stopped
                and self.best_iteration is not None):
            n_trees = self.best_iteration + 1
        return self.trees if n_trees is None else self.trees[:n_trees]

    def _stacked_trees(self, trees: List[Dict[str, np.ndarray]]
                       ) -> Dict[str, torch.Tensor]:
        """The forest as stacked device tensors ``[T, ...]`` (``[T, K,
        ...]`` for ``multi:softmax``), with ``dir`` in missing mode."""
        keys = ("feat", "thr", "leaf") + (("dir",) if "dir" in trees[0]
                                          else ())
        return {k: torch.from_numpy(np.stack([t[k] for t in trees])
                                    ).to(self.device)
                for k in keys}

    def _apply_stacked(self, bins_t: torch.Tensor,
                       st: Dict[str, torch.Tensor],
                       margin: torch.Tensor) -> torch.Tensor:
        """Add a stacked forest's leaves onto ``margin`` ([n], or [n, K]
        class by class), tree by tree in order."""
        depth, miss = self.param.max_depth, self._miss_bin()
        return _by_class(st, lambda s, c: _predict_trees(
            bins_t, s["feat"], s["thr"], s["leaf"], depth,
            margin if c is None else margin[:, c], s.get("dir"), miss), 1)

    def _apply_trees(self, bins_t: torch.Tensor,
                     trees: List[Dict[str, np.ndarray]],
                     init: torch.Tensor) -> torch.Tensor:
        """Add the forest's margins onto ``init`` in training's order —
        the margin replay of a continued fit and :meth:`predict`.  The
        JAX package stacks forests in chunks of ``_TREE_CHUNK`` trees,
        the last padded with all-zero trees; a zero tree adds +0.0, so
        one +0.0 after a short last chunk gives its bits (a margin of
        −0.0 becomes +0.0) without descending the padding."""
        margin = init
        for lo in range(0, len(trees), _TREE_CHUNK):
            part = trees[lo:lo + _TREE_CHUNK]
            margin = self._apply_stacked(bins_t, self._stacked_trees(part),
                                         margin)
            if len(part) < _TREE_CHUNK:
                margin = margin + 0.0
        return margin

    def predict(self, X: np.ndarray, output_margin: bool = False,
                n_trees: Optional[int] = None) -> np.ndarray:
        """Margins (``output_margin``) or transformed predictions: ``[n]``,
        or for ``multi:softmax`` margins ``[n, K]`` and argmax classes
        ``[n]``; in missing mode NaN rows follow each node's learned
        direction."""
        CHECK(self.cuts is not None, "predict before fit")
        CHECK(len(self.trees) > 0, "no trees trained")
        X = np.ascontiguousarray(X, dtype=np.float32)
        self._check_nan_allowed(X, "predict")
        use = self._resolve_trees(n_trees)
        outs = []
        for lo in range(0, len(X), self._PREDICT_BATCH):
            xb = X[lo:lo + self._PREDICT_BATCH]
            margin = self._apply_trees(
                self._bins_of(torch.from_numpy(xb).to(self.device)), use,
                self._base_margin(len(xb)))
            out = margin if output_margin else self._obj.transform(margin)
            outs.append(out.cpu().numpy())
        if not outs:
            return np.zeros(self._margin_shape(0), np.float32)
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def predict_proba(self, X: np.ndarray,
                      n_trees: Optional[int] = None) -> np.ndarray:
        """Class probabilities ``[n, K]`` for ``multi:softmax`` (softmax of
        the margins), ``[n, 2]`` columns ``(1−p, p)`` for
        ``binary:logistic``."""
        p = self.param
        CHECK(p.objective in ("binary:logistic", "multi:softmax"),
              f"predict_proba needs a classification objective, "
              f"got {p.objective!r}")
        margin = torch.from_numpy(self.predict(X, output_margin=True,
                                               n_trees=n_trees))
        if p.num_class > 1:
            return self._obj.prob(margin).numpy()
        prob1 = self._obj.transform(margin).numpy()
        return np.stack([1.0 - prob1, prob1], axis=1)

    def predict_leaf(self, X: np.ndarray,
                     n_trees: Optional[int] = None) -> np.ndarray:
        """Each row's leaf in each tree — XGBoost's ``pred_leaf=True``:
        int32 ``[n, T]`` (``multi:softmax``: ``[n, T, K]``) of positions in
        ``[0, 2^max_depth)`` of the tree's leaf layer.  Rows descend by
        ``descend_kernel`` on the card."""
        CHECK(self.cuts is not None, "predict before fit")
        CHECK(len(self.trees) > 0, "no trees trained")
        use = self._resolve_trees(n_trees)
        X = np.ascontiguousarray(X, dtype=np.float32)
        self._check_nan_allowed(X, "predict_leaf")
        K = self.param.num_class
        if len(X) == 0:
            return np.zeros((0, len(use), K) if K > 1 else (0, len(use)),
                            np.int32)
        st = self._stacked_trees(use)
        depth, miss = self.param.max_depth, self._miss_bin()
        outs = []
        for lo in range(0, len(X), self._PREDICT_BATCH):
            bins_t = self._bins_of(torch.from_numpy(
                X[lo:lo + self._PREDICT_BATCH]).to(self.device))
            out = _by_class(st, lambda s, c: torch.stack([
                _tree_leaf(bins_t, s["feat"][t], s["thr"][t], depth,
                           _at(s.get("dir"), t), miss)
                for t in range(s["feat"].shape[0])], dim=1), 2)
            outs.append(out.cpu().numpy())
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def dump_model(self, with_stats: bool = False,
                   feature_names: Optional[List[str]] = None) -> str:
        """XGBoost-style text dump of the ensemble (``booster[i]:`` per
        tree, ``booster[i] class[c]:`` per class tree, one node per line),
        the JAX package's text: node ``n`` of level ``l`` is id
        ``2^l-1+n`` with children ``2^(l+1)-1+2n`` / ``+2n+1``, the leaf
        layer at level ``max_depth``; splits print the real threshold
        ``cuts[f][thr]`` as ``[f<N><x]`` with yes = left (missing mode:
        ``missing=`` the direction's child; the top value threshold, a
        missingness-only split, as ``<inf``); degenerate nodes print as
        ``passthrough``.  ``with_stats`` appends each real split's gain,
        ``feature_names`` replaces ``f<N>``."""
        CHECK(len(self.trees) > 0, "no trees trained")
        cuts = self.cuts.cpu().numpy()
        if feature_names is not None:
            CHECK_EQ(len(feature_names), cuts.shape[0],
                     "feature_names length must equal n_features")

        def fname(f: int) -> str:
            return feature_names[f] if feature_names is not None else f"f{f}"

        B = self.param.n_bins
        lines: List[str] = []

        def dump_one(feat_t, thr_t, gain_t, leaf_t, dir_t=None):
            n_levels = feat_t.shape[0]
            for level in range(n_levels):
                for nid in range(1 << level):
                    gid = (1 << level) - 1 + nid
                    f = int(feat_t[level][nid])
                    t = int(thr_t[level][nid])
                    kid = (1 << (level + 1)) - 1 + 2 * nid
                    if t >= B - 1:
                        lines.append(f"\t{gid}:passthrough "
                                     f"yes={kid},no={kid + 1}")
                        continue
                    miss = ""
                    if dir_t is not None:     # XGBoost's missing= target
                        d = int(dir_t[level][nid])
                        miss = f",missing={kid if d == 1 else kid + 1}"
                    stat = ""
                    if with_stats and gain_t is not None:
                        stat = f",gain={float(gain_t[level][nid]):.6g}"
                    cond = (f"{fname(f)}<{cuts[f][t]:.6g}"
                            if t < cuts.shape[1] else f"{fname(f)}<inf")
                    lines.append(f"\t{gid}:[{cond}] "
                                 f"yes={kid},no={kid + 1}{miss}{stat}")
            base = (1 << n_levels) - 1
            for i, v in enumerate(np.asarray(leaf_t)):
                lines.append(f"\t{base + i}:leaf={float(v):.6g}")

        for ti, tree in enumerate(self.trees):
            if np.asarray(tree["feat"]).ndim == 3:    # [K, depth, half]
                for c in range(tree["feat"].shape[0]):
                    lines.append(f"booster[{ti}] class[{c}]:")
                    dump_one(tree["feat"][c], tree["thr"][c],
                             tree["gain"][c] if "gain" in tree else None,
                             tree["leaf"][c],
                             tree["dir"][c] if "dir" in tree else None)
            else:
                lines.append(f"booster[{ti}]:")
                dump_one(tree["feat"], tree["thr"], tree.get("gain"),
                         tree["leaf"], tree.get("dir"))
        return "\n".join(lines) + "\n"

    def feature_importances(self, importance_type: str = "weight"
                            ) -> np.ndarray:
        """Per-feature importance over the ensemble: ``"weight"``, the
        count of real splits on each feature (int64); ``"gain"``, their
        summed split gains (float64).  Degenerate nodes (``thr ==
        n_bins-1``) and each level's padding are not splits."""
        CHECK(len(self.trees) > 0, "no trees trained")
        if importance_type not in ("weight", "gain"):
            log_fatal(f"unsupported importance_type {importance_type!r}")
        if importance_type == "gain":
            CHECK(all("gain" in t for t in self.trees),
                  "importance_type='gain' needs trees with stored gains "
                  "(models saved before gain tracking have none)")
        out = np.zeros(int(self.cuts.shape[0]),
                       np.float64 if importance_type == "gain" else np.int64)
        B = self.param.n_bins
        for tree in self.trees:
            feat_t = np.asarray(tree["feat"])
            thr_t = np.asarray(tree["thr"])
            gain_t = (np.asarray(tree["gain"])
                      if importance_type == "gain" else None)
            if feat_t.ndim == 2:            # single-output: [depth, half]
                feat_t, thr_t = feat_t[None], thr_t[None]
                gain_t = None if gain_t is None else gain_t[None]
            for c, (feat_c, thr_c) in enumerate(zip(feat_t, thr_t)):
                for level in range(feat_c.shape[0]):
                    n_nodes = 1 << level
                    feat = feat_c[level][:n_nodes]
                    real = thr_c[level][:n_nodes] < B - 1
                    if gain_t is not None:
                        np.add.at(out, feat[real],
                                  gain_t[c][level][:n_nodes][real])
                    else:
                        np.add.at(out, feat[real], 1)
        return out

    # ------------------------------------------------------------------
    # weights: (param, cuts, trees) in and out, and model files
    # ------------------------------------------------------------------
    def to_state(self) -> Dict[str, Any]:
        """The model as the payload ``save_model`` writes: param dict,
        cuts ``[F, n_bins-1]`` (missing mode: ``[F, n_bins-2]``) f32, the
        per-tree numpy arrays (with ``dir`` in missing mode), the
        early-stopping state and the ``missing`` flag."""
        CHECK(self.cuts is not None and len(self.trees) > 0,
              "to_state before fit")
        return {
            "param": self.param.to_dict(),
            "cuts": self.cuts.cpu().numpy(),
            "trees": self.trees,
            "best_iteration": self.best_iteration,
            "best_score": self.best_score,
            "early_stopped": self._early_stopped,
            "missing": self._missing,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any],
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "HistGBT":
        """A model from a ``to_state`` / ``save_model`` payload (numpy
        arrays) — from this package or the JAX package — that predicts
        the same."""
        param = HistGBTParam()
        param.init(state["param"])
        model = cls(param, device=device)
        model.cuts = torch.as_tensor(np.array(state["cuts"], np.float32),
                                     device=model.device)
        model._missing = bool(state.get("missing", False))
        keys = (("dir",) if model._missing else ()) + _TREE_KEYS
        model.trees = [{k: np.asarray(t[k]) for k in keys}
                       for t in state["trees"]]
        model.best_iteration = state.get("best_iteration")
        model.best_score = state.get("best_score")
        model._early_stopped = state.get("early_stopped", False)
        return model

    def save_model(self, uri: str) -> None:
        """Serialize params + bin cuts + trees to a Stream URI — the JAX
        package's ``DCTGBT01`` file, byte for byte."""
        from dmlc_core_tpu_torch.io.serializer import write_obj
        from dmlc_core_tpu_torch.io.stream import Stream

        state = self.to_state()
        s = Stream.create(uri, "w")
        try:
            s.write(self._MODEL_MAGIC)
            write_obj(s, state)
        finally:
            s.close()

    @classmethod
    def load_model(cls, uri: str,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "HistGBT":
        """Inverse of :meth:`save_model`; reads either package's files."""
        from dmlc_core_tpu_torch.io.serializer import read_obj
        from dmlc_core_tpu_torch.io.stream import Stream

        s = Stream.create(uri, "r")
        try:
            magic = s.read_exact(len(cls._MODEL_MAGIC))
            CHECK_EQ(bytes(magic), cls._MODEL_MAGIC,
                     f"not a HistGBT model: {uri}")
            payload = read_obj(s)
        finally:
            s.close()
        return cls.from_state(payload, device=device)


def _child_bounds(bounds, cg, ch, lam: float, mono, feat, thr, B: int):
    """The ``[2N, 2]`` weight bounds of a level's children from the
    nodes' ``bounds`` [N, 2], their child sums ``cg``/``ch`` [2N] and
    splits: on a real split (``thr < B-1``) of an increasing feature the
    midpoint of the two clipped child weights caps the left child and
    floors the right one, the reverse for a decreasing feature; otherwise
    both children inherit the node's bounds (XGBoost's propagation)."""
    n_nodes = bounds.shape[0]
    lo, hi = bounds[:, 0], bounds[:, 1]
    w_child = (-cg / (ch + lam)).reshape(n_nodes, 2)
    w_child = torch.minimum(torch.maximum(w_child, lo[:, None]), hi[:, None])
    mid = (w_child[:, 0] + w_child[:, 1]) / 2.0
    c = mono[feat.to(torch.int64)]
    real = thr < B - 1                  # degenerate splits are inert
    inc, dec = (c > 0) & real, (c < 0) & real
    up_l = torch.where(inc, torch.minimum(hi, mid), hi)
    lo_r = torch.where(inc, torch.maximum(lo, mid), lo)
    lo_l = torch.where(dec, torch.maximum(lo, mid), lo)
    up_r = torch.where(dec, torch.minimum(hi, mid), hi)
    return torch.stack([torch.stack([lo_l, up_l], 1),
                        torch.stack([lo_r, up_r], 1)], dim=1
                       ).reshape(2 * n_nodes, 2)


def _heap_tables(depth: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per heap id ``i`` in ``[0, 2^(depth+1))``: its level and its leaf
    position (the leftmost depth-level descendant), as device tensors."""
    NH = 1 << (depth + 1)
    level = np.zeros(NH, np.int32)
    pos = np.zeros(NH, np.int64)
    for i in range(1, NH):
        lvl = i.bit_length() - 1
        level[i] = lvl
        pos[i] = (i - (1 << lvl)) << (depth - lvl)
    return (torch.from_numpy(level).to(device),
            torch.from_numpy(pos).to(device))


#: trees per stacked chunk of the JAX package's predict and margin replay
_TREE_CHUNK = 64


def _at(a: Optional[torch.Tensor], i: int) -> Optional[torch.Tensor]:
    return None if a is None else a[i]


def _by_class(st: Dict[str, torch.Tensor], fn, dim: int) -> torch.Tensor:
    """``fn(forest, c)`` over a stacked forest: once with ``c`` None for
    a single-output forest ``[T, depth, half]``, else once per class on
    its ``[:, c]`` slice of ``[T, K, ...]``, stacked along ``dim``."""
    if st["feat"].dim() == 3:
        return fn(st, None)
    return torch.stack([fn({k: v[:, c] for k, v in st.items()}, c)
                        for c in range(st["feat"].shape[1])], dim=dim)


def _tree_leaf(bins_t, feat, thr, depth: int, dirs=None,
               miss_bin: int = -1) -> torch.Tensor:
    """Each row's leaf position in one tree ``[depth, half]``, int32
    ``[n]``: the descend from the root, one ``_advance_node`` a level.
    ``dirs`` with ``miss_bin``: missing mode's routing."""
    node = torch.zeros(bins_t.shape[1], dtype=torch.int32,
                       device=bins_t.device)
    for level in range(depth):
        node = _advance_node(bins_t, node, feat[level], thr[level], None,
                             _at(dirs, level), miss_bin)
    return node


def _predict_trees(bins_t, feats, thrs, leaves, depth: int, init,
                   dirs=None, miss_bin: int = -1):
    """Sum leaf values over trees ``[T, depth, half]`` onto ``init`` [n],
    tree by tree in order (the summation order of training's margin
    updates)."""
    total = init
    for t in range(feats.shape[0]):
        total = total + leaves[t][_tree_leaf(bins_t, feats[t], thrs[t],
                                             depth, _at(dirs, t), miss_bin)]
    return total
