"""Forest prediction: every tree of a forest in one launch (PyTorch port).

The counterpart of the JAX package's compiled ``_predict_trees`` and
``_leaf_indices`` (``dmlc_core_tpu/models/histgbt.py:2962, :2989``),
which XLA builds into one program a chunk of ``_TREE_CHUNK`` (64) trees.
Here one hand-written CUDA kernel (``csrc/forest.cu``) walks every tree of
a forest — all chunks and, under ``multi:softmax``, all classes — beside a
plain PyTorch version of the same function:

* :func:`forest_kernel` / :func:`predict_forest_plain` — with ``init``
  the margins ``init + Σ leaf_t[node_t(row)]`` added tree by tree in
  training's order (one f32 rounding an add), then ``+ 0.0`` when the
  forest's last 64-tree chunk is short (the JAX package pads it with
  all-zero trees: a margin of −0.0 becomes +0.0); without ``init`` each
  row's leaf position in each tree (``predict_leaf``).

:func:`predict_forest` is the entry point: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version, and nothing falls
back from one to the other.  Rows walk ``node = 2·node + (bin > thr)``
(``descend_plain``'s rule); in missing mode a row whose bin is the
reserved NaN bin follows its node's learned direction (1 = left).

Both read one packed form of the forest (:func:`pack_forest`), so that a
packing fault shows on the CPU: a fixed-size, 16-byte-aligned record a
tree, trees class-major (class ``c``'s trees in round order, then class
``c+1``'s), each

* ``leaves`` f32 ``[2^depth]``;
* ``dirs`` u32 ``[⌈(2^depth − 1)/32⌉]`` in missing mode (bit ``h`` = 1:
  heap node ``h`` sends its missing rows right), else nothing;
* ``records`` ``[2^depth − 1]`` in heap order (level by level), each
  naming its split feature by its place in the kernel's tile: ``slot``
  (an index into ``used``, the forest's distinct split features — the
  rows of the bin matrix the kernel stages) as quad ``q = slot // 4`` and
  byte ``k = slot % 4``.  u16 ``q << 10 | k << 8 | thr`` when the forest
  splits on at most 256 distinct features with every threshold in ``[0,
  255]``, else u32 ``(128·q + k) << 9 | (thr + 1)`` — the feature's byte
  offset in a warp's tile — with ``thr`` clamped to ``[−1, 255]`` (bins
  are bytes: the clamp changes no comparison).

The padding slots of the ``[depth, half]`` tables (node ``i ≥ 2^level`` of
a level) are never reached and are not packed; lossguide's unexpanded
nodes (feat 0, thr ``B−1``, leaves −0.0) pack as any other node.
Prediction reads the plain ``[F, n]`` matrix only (``_resume_margin``
refuses packed handles).

The per-level chain that this kernel replaced (``descend_kernel`` a tree
level, then a gather and an add a tree) stays in the package as
``models.histgbt._predict_trees``: no route calls it; the tests and
``chip_smoke.py`` hold the forest kernel against it and time it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal

__all__ = ["Forest", "pack_forest", "unpack_forest", "forest_plan",
           "predict_forest", "predict_forest_plain", "forest_kernel",
           "warm_launch", "forest_bounds"]

#: rows a thread walks side by side (``kRowsPerThread``), threads a block
#: at most (``kMaxThreads``) and blocks an SM the kernel is built for
#: (``__launch_bounds__``) in csrc/forest.cu
ROWS_PER_THREAD = 4
MAX_THREADS = 256
BLOCKS_PER_SM = 3


class Forest(NamedTuple):
    """A forest packed for :func:`forest_kernel` and
    :func:`predict_forest_plain` (see the module docstring).  ``blob``
    and ``used`` live on the forest's device; the rest are host ints."""
    blob: torch.Tensor       # uint8 [n_trees · tree_bytes]
    used: torch.Tensor       # int32 [n_used]: bin-matrix row of a slot
    max_feature: int         # max(used): the matrix needs more rows
    depth: int
    per_class: int           # trees a class (T)
    n_class: int             # K (1: a single output)
    wide: bool               # u32 records, else u16
    missing: bool            # direction bits present
    miss_bin: int            # the reserved NaN bin, or −1
    add_zero: bool           # + 0.0 at the end (a short last chunk)
    tree_bytes: int
    dir_off: int
    rec_off: int

    @property
    def n_trees(self) -> int:
        return self.per_class * self.n_class

    @property
    def n_used(self) -> int:
        return int(self.used.shape[0])


def _tree_layout(depth: int, wide: bool, missing: bool
                 ) -> Tuple[int, int, int]:
    """``(dir_off, rec_off, tree_bytes)`` of a packed tree."""
    n_leaf = 1 << depth
    dir_words = -(-(n_leaf - 1) // 32) if missing else 0
    dir_off = 4 * n_leaf
    rec_off = dir_off + 4 * dir_words
    size = rec_off + (4 if wide else 2) * (n_leaf - 1)
    return dir_off, rec_off, -(-size // 16) * 16


def _heap(a: np.ndarray, depth: int) -> np.ndarray:
    """``[J, depth, half]`` per-level tables → ``[J, 2^depth − 1]`` in
    heap order, the padding slots dropped."""
    return np.concatenate([a[:, lv, :1 << lv] for lv in range(depth)],
                          axis=1)


def pack_forest(trees: List[Dict[str, np.ndarray]], depth: int,
                device, miss_bin: int = -1,
                add_zero: bool = False) -> Forest:
    """Pack ``trees`` (training's order; each ``feat``/``thr`` (and
    ``dir``) ``[depth, half]`` and ``leaf`` ``[2^depth]``, or ``[K, ...]``
    under ``multi:softmax``) for the device ``device``.  ``miss_bin`` is
    the reserved NaN bin of missing mode (the trees then carry ``dir``);
    ``add_zero`` ends each margin with ``+ 0.0``."""
    CHECK(len(trees) > 0, "pack_forest: no trees")
    CHECK(1 <= depth <= 12, f"pack_forest: depth {depth} outside [1, 12]")
    missing = "dir" in trees[0]

    def stacked(key, dtype):
        a = np.stack([np.asarray(t[key]) for t in trees]).astype(dtype)
        if a.ndim == (3 if key != "leaf" else 2):   # single output
            a = a[:, None]
        T, K = a.shape[:2]
        return np.ascontiguousarray(a.swapaxes(0, 1)).reshape(
            (T * K,) + a.shape[2:]), T, K

    feat, T, K = stacked("feat", np.int64)
    thr = stacked("thr", np.int64)[0]
    leaf = stacked("leaf", np.float32)[0]
    n_leaf = 1 << depth
    CHECK(feat.shape[1:] == (depth, max(n_leaf >> 1, 1))
          and leaf.shape[1:] == (n_leaf,),
          f"pack_forest: tables {feat.shape[1:]} / {leaf.shape[1:]} are "
          f"not those of depth {depth}")
    f_h = _heap(feat, depth)
    t_h = np.clip(_heap(thr, depth), -1, 255)
    used, slot = np.unique(f_h, return_inverse=True)
    slot = slot.reshape(f_h.shape)
    CHECK(used[0] >= 0, f"pack_forest: negative feature {used[0]}")
    CHECK(len(used) <= 1 << 16,
          f"pack_forest: {len(used)} distinct split features (at most "
          "65536)")
    wide = len(used) > 256 or bool((t_h < 0).any())
    dir_off, rec_off, tree_bytes = _tree_layout(depth, wide, missing)
    J = T * K
    blob = np.zeros((J, tree_bytes), np.uint8)
    blob[:, :dir_off] = leaf.view(np.uint8).reshape(J, -1)
    if missing:
        d_h = stacked("dir", np.int64)[0]
        bits = (_heap(d_h, depth) == 0).astype(np.uint64)
        words = (rec_off - dir_off) // 4
        bits = np.pad(bits, ((0, 0), (0, 32 * words - bits.shape[1])))
        packed = (bits.reshape(J, words, 32)
                  << np.arange(32, dtype=np.uint64)).sum(2)
        blob[:, dir_off:rec_off] = packed.astype(np.uint32).view(
            np.uint8).reshape(J, -1)
    q, k = slot >> 2, slot & 3
    if wide:
        rec = ((((q << 7) | k) << 9) | (t_h + 1)).astype(np.uint32)
    else:
        rec = ((q << 10) | (k << 8) | t_h).astype(np.uint16)
    rec_end = rec_off + rec.itemsize * (n_leaf - 1)
    blob[:, rec_off:rec_end] = rec.view(np.uint8).reshape(J, -1)
    return Forest(
        blob=torch.from_numpy(blob.reshape(-1)).to(device),
        used=torch.from_numpy(used.astype(np.int32)).to(device),
        max_feature=int(used[-1]), depth=depth, per_class=T, n_class=K,
        wide=wide, missing=missing, miss_bin=int(miss_bin) if missing
        else -1, add_zero=bool(add_zero), tree_bytes=tree_bytes,
        dir_off=dir_off, rec_off=rec_off)


def _decode(forest: Forest) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, Optional[torch.Tensor]]:
    """The packed tables as tensors on the forest's device: ``(leaves
    [J, 2^depth] f32, slot [J, 2^depth−1], thr [J, 2^depth−1] int64,
    right-on-missing [J, 2^depth−1] bool or None)``."""
    J, L = forest.n_trees, 1 << forest.depth
    blob = forest.blob.reshape(J, forest.tree_bytes)
    leaves = blob[:, :4 * L].contiguous().view(torch.float32)
    width = 4 if forest.wide else 2
    raw = blob[:, forest.rec_off:forest.rec_off + width * (L - 1)]
    raw = raw.contiguous().view(torch.int32 if forest.wide else torch.int16)
    rec = raw.to(torch.int64) & (0xFFFFFFFF if forest.wide else 0xFFFF)
    if forest.wide:
        off, thr = rec >> 9, (rec & 0x1FF) - 1
        slot = 4 * (off >> 7) + (off & 3)
    else:
        slot, thr = 4 * (rec >> 10) + ((rec >> 8) & 3), rec & 0xFF
    right = None
    if forest.missing:
        words = blob[:, forest.dir_off:forest.rec_off].contiguous().view(
            torch.int32).to(torch.int64) & 0xFFFFFFFF
        h = torch.arange(L - 1, device=blob.device)
        right = ((words[:, h >> 5] >> (h & 31)) & 1).bool()
    return leaves, slot, thr, right


def unpack_forest(forest: Forest) -> Dict[str, np.ndarray]:
    """The packed forest back as stacked tables (``[T, depth, half]``,
    ``[T, K, depth, half]`` under ``multi:softmax``; ``leaf``
    ``[T(, K), 2^depth]``), the padding slots 0 — the inverse of
    :func:`pack_forest` on every reached node (thresholds as clamped to
    ``[−1, 255]``)."""
    leaves, slot, thr, right = _decode(forest)
    used = forest.used.cpu().numpy().astype(np.int64)
    depth, T, K = forest.depth, forest.per_class, forest.n_class
    half = max((1 << depth) >> 1, 1)

    def levels(h):                         # [J, 2^depth−1] → [J, depth, half]
        out = np.zeros((h.shape[0], depth, half), np.int32)
        for lv in range(depth):
            out[:, lv, :1 << lv] = h[:, (1 << lv) - 1:(1 << (lv + 1)) - 1]
        return out

    def classes(a):                        # class-major [J, ...] → [T(, K), ...]
        a = a.reshape((K, T) + a.shape[1:]).swapaxes(0, 1)
        return np.ascontiguousarray(a[:, 0] if K == 1 else a)

    out = {"feat": classes(levels(used[slot.cpu().numpy()])),
           "thr": classes(levels(thr.cpu().numpy())),
           "leaf": classes(leaves.cpu().numpy())}
    if right is not None:
        out["dir"] = classes(levels((~right).cpu().numpy().astype(np.int64)))
    return out


def _check_bins(bins_t: torch.Tensor, forest: Forest) -> None:
    CHECK(bins_t.dtype == torch.uint8 and bins_t.dim() == 2,
          "bins_t must be a feature-major [F, n] uint8 tensor")
    CHECK(forest.max_feature < bins_t.shape[0],
          f"the forest splits on feature {forest.max_feature}; the bin "
          f"matrix has {bins_t.shape[0]} rows")


def _check_init(init: torch.Tensor, forest: Forest, n: int,
                device) -> None:
    want = (n,) if forest.n_class == 1 else (n, forest.n_class)
    CHECK(init.dtype == torch.float32 and tuple(init.shape) == want
          and init.device == device,
          f"init must be a {list(want)} float32 tensor on {device}")


def predict_forest_plain(bins_t: torch.Tensor, forest: Forest,
                         init: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of :func:`forest_kernel` on the same packed tables:
    margins ``[n]`` (``[n, K]``) from ``init``, or without ``init`` leaf
    positions int32 ``[n, T]`` (``[n, T, K]``)."""
    _check_bins(bins_t, forest)
    n = bins_t.shape[1]
    dev = bins_t.device
    if init is not None:
        _check_init(init, forest, n, dev)
    leaves, slot, thr, right = _decode(forest)
    sel = bins_t.index_select(0, forest.used.to(dev, torch.int64))
    cols = torch.arange(n, device=dev)
    first_leaf = (1 << forest.depth) - 1
    T, K = forest.per_class, forest.n_class
    out = []
    for c in range(K):
        acc = None if init is None else (init if K == 1 else init[:, c])
        nodes = []
        for t in range(T):
            j = c * T + t
            h = torch.zeros(n, dtype=torch.int64, device=dev)
            for _ in range(forest.depth):
                b = sel[slot[j][h], cols].to(torch.int64)
                go = b > thr[j][h]
                if right is not None:
                    go = torch.where(b == forest.miss_bin, right[j][h], go)
                h = 2 * h + 1 + go.to(torch.int64)
            node = h - first_leaf
            if acc is None:
                nodes.append(node.to(torch.int32))
            else:
                acc = acc + leaves[j][node]
        if acc is None:
            out.append(torch.stack(nodes, dim=1))
        else:
            out.append(acc + 0.0 if forest.add_zero else acc)
    if K == 1:
        return out[0]
    return torch.stack(out, dim=2 if init is None else 1)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _lib():
    from dmlc_core_tpu_torch.ops._build import load_library

    return load_library("forest")


def forest_plan(n_used: int, tree_bytes: int, n_trees: int, n: int,
                limits: Tuple[int, int, int, int]) -> Tuple[int, int, int]:
    """``(threads, group_trees, smem)`` of a :func:`forest_kernel` launch
    on a card of ``limits`` (``ops.histogram._device_limits``: SMs, the
    shared bytes a block may opt in to, an SM's, the bytes the system
    reserves a block).  A block's shared memory holds its tile of
    ``4·threads`` rows (``⌈n_used/4⌉`` words a row) and one group of
    trees (the whole forest where it fits), else two (the next one
    copied while the current one is walked).  Fewest threads that still
    cover ``n`` rows up to 256; three blocks an SM where they fit, else
    two, else one; fewer threads when even one tree does not fit beside
    the tile (at 32 threads a tile is 128 rows: ~1,400 distinct split
    features at depth 12, ~1,800 at depth 6)."""
    _, block_max, sm_bytes, reserve = limits
    quads = -(-n_used // 4)
    threads = MAX_THREADS
    while threads > 32 and threads * ROWS_PER_THREAD // 2 >= n:
        threads //= 2
    while threads >= 32:
        tile = quads * 4 * threads * ROWS_PER_THREAD
        for budget in [min(block_max, sm_bytes // b - reserve)
                       for b in range(BLOCKS_PER_SM, 0, -1)]:
            room = budget - tile
            if n_trees * tree_bytes <= room:
                return threads, n_trees, tile + n_trees * tree_bytes
            group = room // (2 * tree_bytes)
            if group >= 1:
                return threads, group, tile + 2 * group * tree_bytes
        threads //= 2
    log_fatal(f"forest_kernel: {n_used} split features and trees of "
              f"{tree_bytes} bytes do not fit a block's shared memory "
              f"({block_max} bytes)")


def _launch(bins_t: torch.Tensor, forest: Forest,
            init: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """One launch of ``csrc/forest.cu`` on checked tensors (``n > 0``):
    margins into ``out`` from ``init``, or leaf positions without."""
    from dmlc_core_tpu_torch.ops.histogram import _check_launch, _device_limits

    dev = bins_t.device
    n = bins_t.shape[1]
    threads, group, smem = forest_plan(
        forest.n_used, forest.tree_bytes, forest.n_trees, n,
        _device_limits(dev.index if dev.index is not None
                       else torch.cuda.current_device()))
    rc = _lib().dmlc_predict_forest(
        bins_t.data_ptr(), n, forest.used.data_ptr(), forest.n_used,
        forest.blob.data_ptr(), forest.tree_bytes, forest.dir_off,
        forest.rec_off, int(forest.wide), forest.n_trees, forest.per_class,
        forest.n_class, forest.depth, int(forest.missing), forest.miss_bin,
        int(forest.add_zero), None if init is None else init.data_ptr(),
        None if init is None else out.data_ptr(),
        out.data_ptr() if init is None else None, threads, group, smem,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(rc, "dmlc_predict_forest")


def forest_kernel(bins_t: torch.Tensor, forest: Forest,
                  init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CUDA forest prediction, one launch: the function of
    :func:`predict_forest_plain` (margins from ``init``, else leaf
    positions).  Counts its launches in ``forest_kernel.launches``."""
    from dmlc_core_tpu_torch.ops.histogram import _count

    CHECK(bins_t.is_cuda, "kernel inputs must be CUDA tensors")
    _check_bins(bins_t, forest)
    CHECK(bins_t.is_contiguous(), "bins_t must be contiguous")
    dev = bins_t.device
    CHECK(forest.blob.device == dev and forest.used.device == dev,
          f"the packed forest must be on {dev}")
    n = bins_t.shape[1]
    T, K = forest.per_class, forest.n_class
    if init is None:
        out = torch.empty((n, T) if K == 1 else (n, T, K), dtype=torch.int32,
                          device=dev)
    else:
        _check_init(init, forest, n, dev)
        init = init.contiguous()
        out = torch.empty_like(init)
    if n == 0:
        return out
    _launch(bins_t, forest, init, out)
    _count(forest_kernel, "launches")
    return out


forest_kernel.launches = 0


def predict_forest(bins_t: torch.Tensor, forest: Forest,
                   init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Margins from ``init`` (else leaf positions) of a packed forest:
    :func:`forest_kernel` on CUDA tensors, :func:`predict_forest_plain`
    on CPU tensors."""
    if bins_t.is_cuda:
        return forest_kernel(bins_t, forest, init)
    return predict_forest_plain(bins_t, forest, init)


def warm_launch(device: torch.device) -> None:
    """Launch each of the kernel's four instantiations (u16 and u32
    records, with and without directions) once on 64 rows of a one-tree
    forest on ``device``'s current stream: CUDA loads a kernel at its
    first launch, and the cold-start handle calls this so that an eval
    set's first chunk does not pay it.  The results are thrown away and
    no count moves."""
    bins = torch.zeros(1, 64, dtype=torch.uint8, device=device)
    init = torch.zeros(64, dtype=torch.float32, device=device)
    for thr in (0, -1):                         # u16, then u32 records
        for missing in (False, True):
            tree = {"feat": np.zeros((1, 1), np.int32),
                    "thr": np.full((1, 1), thr, np.int32),
                    "leaf": np.zeros(2, np.float32)}
            if missing:
                tree["dir"] = np.ones((1, 1), np.int32)
            forest = pack_forest([tree], 1, device, miss_bin=255)
            _launch(bins, forest, init, torch.empty_like(init))


# ---------------------------------------------------------------------------
# bound
# ---------------------------------------------------------------------------

#: one H100 SXM's shared-memory lookup rate: 132 SMs × 32 lanes a clock
#: at the 1.98 GHz boost clock (NVIDIA's data sheet)
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9


def forest_bounds(n: int, n_used: int, forest: Forest, hbm_bytes_per_s: float,
                  leaves: bool = False) -> Dict[str, float]:
    """The two terms of the kernel's bound, in ms: ``bytes`` (each row's
    ``n_used`` bin bytes and its init read once, its output written once,
    and the packed tables) over the card's memory rate, and ``lookups``
    (trees × depth shared-memory node lookups a row) over
    :data:`SMEM_LOOKUPS_PER_S`."""
    K, T = forest.n_class, forest.per_class
    out_bytes = 4 * T * K if leaves else 4 * K
    in_bytes = n_used + (0 if leaves else 4 * K)
    nbytes = n * (in_bytes + out_bytes) + forest.blob.numel()
    lookups = n * forest.n_trees * forest.depth
    return {"bytes_ms": nbytes / hbm_bytes_per_s * 1e3,
            "lookups_ms": lookups / SMEM_LOOKUPS_PER_S * 1e3,
            "bytes": float(nbytes), "lookups": float(lookups)}
