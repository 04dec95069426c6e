"""Per-feature bin-width layouts: int4 bin packing and exclusive feature
bundling (PyTorch port).

The counterpart of ``dmlc_core_tpu/ops/binlayout.py``, with the same names
and semantics.  The feature-major bin matrix ``uint8 [F, n]`` spends one
byte per row on every feature, whatever its number of occupied bins.  A
:class:`BinLayout` describes two exact storage transforms:

* **Packing** (``DMLC_BIN_PACK=1``): storage features with at most
  :data:`PACK_WIDTH` occupied bins are compact-remapped (occupied original
  bin ids → dense ``[0, count)``) and paired two per byte (low nibble,
  then high nibble) in the physical matrix.
* **Bundling** (``DMLC_FEATURE_BUNDLE=1``): mutually exclusive
  (near-one-hot) features fuse into ONE storage feature.  Member f's bins
  ``[1, w_f)`` map to the storage segment ``[off_f, off_f + w_f − 1)``;
  storage bin 0 means "every member at its default bin".

Histograms build in STORAGE space ``[2, N, S, Bs]``; :func:`unbundle_hist`
maps them back to the original ``[2, N, F, B]`` for split scoring, so
trees (and model files) stay in the original feature and bin space.  A
trivial layout (no pair packs, no bundle) is ``None``.

The packed region keeps the reference's padding to a multiple of 8 rows,
so :func:`pack_matrix` is byte-equal to the JAX package's.  Layout
decisions are numpy; the matrix work is torch on the matrix's device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.ops.quantile import xla_cumsum

__all__ = ["BinLayout", "compute_layout", "used_bin_widths",
           "bin_counts", "compact_counts", "default_bins",
           "detect_bundles", "layout_tables", "pack_matrix",
           "unpack_matrix", "unbundle_hist", "select_bins", "kernel_tables",
           "hist_groups", "PACK_WIDTH", "DEC_WIDTH", "CELL_BYTES"]

#: max COMPACT bin count eligible for nibble packing (two features/byte)
PACK_WIDTH = 16


class BinLayout(NamedTuple):
    """Static storage layout of the feature-major bin matrix.

    ``members[s]`` lists the original features carried by storage
    feature ``s`` as ``(orig_feat, offset, width)`` triples — one for a
    plain feature (offset 0), more for a bundle.  ``pairs`` holds the
    nibble-packed storage pairs (``byte = lo | hi << 4``) and ``singles``
    the other storage features in physical order; the packed region is
    padded with zero rows to a multiple of 8 rows.

    ``bin_maps[f]`` is the compact remap of original feature ``f``: the
    occupied original bin ids (sorted; a bundle member's DEFAULT bin
    first), or ``None`` for a wide feature stored at its raw ids."""
    n_features: int                                  # original F
    n_bins: int                                      # split-eval width B
    widths: Tuple[int, ...]                          # per-storage width
    members: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    pairs: Tuple[Tuple[int, int], ...]
    singles: Tuple[int, ...]
    bin_maps: Tuple[Optional[Tuple[int, ...]], ...]  # per-ORIGINAL feat

    @property
    def storage_features(self) -> int:
        return len(self.widths)

    @property
    def sync_bins(self) -> int:
        """Histogram build width: the widest storage feature."""
        return max(self.widths)

    @property
    def packed_rows(self) -> int:
        """Physical rows in the packed region (8-row padded)."""
        p = len(self.pairs)
        return -(-p // 8) * 8 if p else 0

    @property
    def phys_rows(self) -> int:
        return self.packed_rows + len(self.singles)

    @property
    def has_bundles(self) -> bool:
        return any(len(m) > 1 for m in self.members)


def used_bin_widths(bins_t: torch.Tensor) -> np.ndarray:
    """Per-feature used bin width (max bin + 1) of a ``[F, n]`` matrix."""
    return bins_t.to(torch.int32).amax(dim=1).cpu().numpy() + 1


def bin_counts(bins_t: torch.Tensor, n_bins: int,
               n_valid: Optional[int] = None) -> np.ndarray:
    """Per-feature bin occupancy counts ``int32 [F, n_bins]`` of a
    ``[F, n]`` binned matrix over its first ``n_valid`` rows (all rows by
    default).  Integer counts: the same on every device."""
    F, n = bins_t.shape
    m = n if n_valid is None else min(n_valid, n)
    rows = [torch.bincount(bins_t[f, :m].to(torch.int64), minlength=n_bins)
            for f in range(F)]
    if not rows:
        return np.zeros((0, n_bins), np.int32)
    return torch.stack(rows).cpu().numpy().astype(np.int32)


def compact_counts(counts: np.ndarray) -> np.ndarray:
    """Per-feature COMPACT bin count: number of occupied bins."""
    return (np.asarray(counts) > 0).sum(axis=1).astype(np.int64)


def default_bins(counts: np.ndarray) -> np.ndarray:
    """Per-feature DEFAULT bin: the most frequent occupied bin (ties →
    lowest id).  A bundle member at its default is "absent"."""
    return np.asarray(counts).argmax(axis=1).astype(np.int64)


def compute_layout(counts: np.ndarray, n_features: int, n_bins: int, *,
                   pack: bool = True,
                   bundles: Tuple[Tuple[int, ...], ...] = (),
                   ) -> Optional[BinLayout]:
    """A :class:`BinLayout` from the occupancy counts ``int [F, n_bins]``
    and verified exclusive bundles, or ``None`` when no pair packs and no
    bundle fires.  Features with at most :data:`PACK_WIDTH` occupied bins
    get a compact remap; storage widths are compact counts for remapped
    features and ``max + 1`` for wide ones."""
    counts = np.asarray(counts)
    CHECK(counts.shape == (n_features, n_bins),
          "counts/feature-count mismatch")
    presence = counts > 0
    occs = [tuple(int(i) for i in np.nonzero(presence[f])[0]) or (0,)
            for f in range(n_features)]
    defaults = default_bins(counts)
    maxw = [max(int(np.nonzero(presence[f])[0][-1]) + 1, 1)
            if presence[f].any() else 1 for f in range(n_features)]
    remapped = [len(occs[f]) <= PACK_WIDTH for f in range(n_features)]
    cnt = [len(occs[f]) for f in range(n_features)]
    in_bundle = {}
    for b in bundles:
        for f in b:
            CHECK(f not in in_bundle, f"feature {f} in two bundles")
            CHECK(remapped[f],
                  f"bundle member {f} not compact (count {cnt[f]})")
            in_bundle[f] = b
    bin_maps = []
    for f in range(n_features):
        if not remapped[f]:
            bin_maps.append(None)
        elif f in in_bundle:               # default-first compact order
            d = int(defaults[f])
            bin_maps.append((d,) + tuple(i for i in occs[f] if i != d))
        else:
            bin_maps.append(occs[f])
    bin_maps = tuple(bin_maps)
    st_widths, st_members = [], []
    emitted = set()
    for f in range(n_features):
        b = in_bundle.get(f)
        if b is None:
            w = cnt[f] if remapped[f] else maxw[f]
            st_widths.append(max(w, 1))
            st_members.append(((f, 0, w),))
            continue
        if b[0] != f or b in emitted:
            continue                       # bundle emitted at first member
        emitted.add(b)
        off, mems = 1, []
        for g in b:                        # member widths are COMPACT
            mems.append((g, off, cnt[g]))
            off += max(cnt[g] - 1, 0)
        CHECK(off <= n_bins,
              f"bundle width {off} exceeds n_bins={n_bins}")
        st_widths.append(off)
        st_members.append(tuple(mems))
    packable = ([s for s, w in enumerate(st_widths) if w <= PACK_WIDTH]
                if pack else [])
    pairs = tuple(zip(packable[0::2], packable[1::2]))
    paired = {s for pr in pairs for s in pr}
    singles = tuple(s for s in range(len(st_widths)) if s not in paired)
    if not pairs and not any(len(m) > 1 for m in st_members):
        return None
    return BinLayout(n_features=n_features, n_bins=n_bins,
                     widths=tuple(st_widths), members=tuple(st_members),
                     pairs=pairs, singles=singles, bin_maps=bin_maps)


def detect_bundles(sample_bins_t: np.ndarray, counts: np.ndarray,
                   n_bins: int, max_conflicts: int = 0,
                   ) -> Tuple[Tuple[int, ...], ...]:
    """Greedy exclusive-feature-bundle PROPOSER over a host bin sample
    ``[F, m]`` (LightGBM's EFB, exact-conflict variant): two features
    conflict when a sampled row has both off their DEFAULT bin
    (:func:`default_bins` of the full-data ``counts``).  Members must be
    compact (≤ :data:`PACK_WIDTH` occupied bins).  Proposals must still
    be verified on the full matrix (``HistGBT._bundle_exclusive``)."""
    F = sample_bins_t.shape[0]
    ccnt = compact_counts(counts)
    dflt = default_bins(counts)
    nz = sample_bins_t != dflt[:, None]                  # [F, m] off-default
    density = nz.mean(axis=1)
    cand = sorted((f for f in range(F)
                   if density[f] <= 0.5 and 2 <= ccnt[f] <= PACK_WIDTH),
                  key=lambda f: density[f])
    bundles, used = [], set()
    for f in cand:
        if f in used:
            continue
        group, mask, width = [f], nz[f].copy(), int(ccnt[f])
        for g in cand:
            if g in used or g == f or g in group:
                continue
            if width + int(ccnt[g]) - 1 > n_bins:
                continue
            if int(np.count_nonzero(mask & nz[g])) > max_conflicts:
                continue
            group.append(g)
            mask |= nz[g]
            width += int(ccnt[g]) - 1
        if len(group) >= 2:
            used.update(group)
            bundles.append(tuple(sorted(group)))
    return tuple(bundles)


@lru_cache(maxsize=64)
def layout_tables(layout: BinLayout) -> dict:
    """Static numpy index tables derived from a layout (cached: the
    layout is hashable and lives for the fit)."""
    S = layout.storage_features
    Pp = layout.packed_rows
    src = np.zeros(S, np.int32)            # physical row of storage s
    nib = np.full(S, -1, np.int32)         # 0=low nibble, 1=high, -1=byte
    logical = np.zeros(S, np.int32)        # kernel-logical row of storage s
    for i, (a, b) in enumerate(layout.pairs):
        src[a], nib[a], logical[a] = i, 0, 2 * i
        src[b], nib[b], logical[b] = i, 1, 2 * i + 1
    for j, s in enumerate(layout.singles):
        src[s], logical[s] = Pp + j, 2 * Pp + j
    F = layout.n_features
    owner = np.zeros(F, np.int32)          # storage feature of original f
    off = np.zeros(F, np.int32)
    wid = np.zeros(F, np.int32)
    bundled = np.zeros(F, bool)
    for s, mems in enumerate(layout.members):
        for f, o, w in mems:
            owner[f], off[f], wid[f] = s, o, w
            bundled[f] = len(mems) > 1
    # compact remap tables: occ_pad[f, c] = original bin of compact id c
    # (sentinel n_bins beyond the width — never matched, never scattered)
    remap = np.array([m is not None for m in layout.bin_maps], bool)
    occ_pad = np.full((F, PACK_WIDTH), layout.n_bins, np.int32)
    for f, m in enumerate(layout.bin_maps):
        if m is not None:
            occ_pad[f, :len(m)] = m
    # storage-cell → eval-cell scatter (plain features; bundles are
    # reconstructed by the tot − segment pass in unbundle_hist)
    Bs = layout.sync_bins
    sc_feat = np.full((S, Bs), F, np.int32)      # F ⇒ dropped
    sc_bin = np.zeros((S, Bs), np.int32)
    for s, mems in enumerate(layout.members):
        if len(mems) != 1:
            continue
        f, _, w = mems[0]
        m = layout.bin_maps[f]
        for c in range(w):
            sc_feat[s, c] = f
            sc_bin[s, c] = m[c] if m is not None else c
    return dict(src=src, nib=nib, logical=logical, owner=owner,
                off=off, wid=wid, bundled=bundled,
                bundled_feats=tuple(int(f) for f in np.nonzero(bundled)[0]),
                remap=remap, any_remap=bool(remap.any()),
                occ_pad=occ_pad, sc_feat=sc_feat, sc_bin=sc_bin)


def _storage_lut(layout: BinLayout) -> np.ndarray:
    """``lut[f, v]``: the storage value original feature ``f`` writes for
    original bin ``v`` — its compact id (``Σ_k k·[v == occ_pad[f, k]]``,
    0 for an unoccupied id) and, for a bundle member, the segment encode
    (``off + c − 1``, 0 at the default)."""
    t = layout_tables(layout)
    F = layout.n_features
    lut = np.tile(np.arange(256, dtype=np.int32), (F, 1))
    v = np.arange(256, dtype=np.int32)
    for f in range(F):
        if t["remap"][f]:
            c = np.zeros(256, np.int32)
            for k in range(1, PACK_WIDTH):
                c += k * (v == t["occ_pad"][f, k])
            lut[f] = c
        if t["bundled"][f]:
            lut[f] = np.where(lut[f] > 0, t["off"][f] + lut[f] - 1, 0)
    return lut


def pack_matrix(bins_t: torch.Tensor, layout: BinLayout) -> torch.Tensor:
    """``[F, n]`` uint8 original matrix → ``[phys_rows, n]`` uint8
    physical matrix (compact remap, bundle encode, nibble pack), byte-equal
    to the JAX package's.  One storage row at a time, so the transient
    memory is a few ``[n]`` int32 vectors."""
    lut = torch.from_numpy(_storage_lut(layout)).to(bins_t.device)
    n = bins_t.shape[1]

    def storage_row(s):
        acc = torch.zeros(n, dtype=torch.int32, device=bins_t.device)
        for f, _, _ in layout.members[s]:
            acc += lut[f][bins_t[f].to(torch.int64)]
        return acc

    out = torch.zeros(layout.phys_rows, n, dtype=torch.uint8,
                      device=bins_t.device)
    for i, (a, b) in enumerate(layout.pairs):
        out[i] = (storage_row(a) | (storage_row(b) << 4)).to(torch.uint8)
    for j, s in enumerate(layout.singles):
        out[layout.packed_rows + j] = storage_row(s).to(torch.uint8)
    return out


def unpack_matrix(phys: torch.Tensor, layout: BinLayout) -> torch.Tensor:
    """``[phys_rows, n]`` physical matrix → ``[S, n]`` uint8 STORAGE
    matrix (nibbles extracted; bundles left fused)."""
    t = layout_tables(layout)
    dev = phys.device
    m = phys[torch.from_numpy(t["src"]).to(dev).long()].to(torch.int32)
    nib = torch.from_numpy(t["nib"]).to(dev)[:, None]
    v = torch.where(nib == 1, m >> 4, torch.where(nib == 0, m & 15, m))
    return v.to(torch.uint8)


#: columns of the decode table (one row per ORIGINAL feature): physical
#: row, nibble (−1 byte / 0 low / 1 high), bundled, segment offset,
#: segment width, remapped, the :data:`PACK_WIDTH` entries of the compact
#: remap (``occ_pad``), then 2 of padding (96-byte rows, which the CUDA
#: descend reads as one int4 and one int2)
DEC_SRC, DEC_NIB, DEC_BUNDLED, DEC_OFF, DEC_WID, DEC_REMAP, DEC_OCC = range(7)
DEC_WIDTH = DEC_OCC + PACK_WIDTH + 2


def _put(a, device, dtype=torch.int64) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


@lru_cache(maxsize=64)
def _device_tables(layout: BinLayout, device: torch.device) -> dict:
    """:func:`layout_tables` as index tensors on ``device`` (cached per
    layout and device, so the training loop uploads nothing per call):
    the plain-cell scatter of :func:`unbundle_hist`, its bundle members
    padded to the widest, and the two tables the CUDA kernels read —
    ``slots [phys_rows, 3]`` int32, (storage_lo, storage_hi, runs) per
    physical row: (a, b, 1) packed, (s, −1, runs) single, (−1, −1, 0)
    padding, with ``runs`` 1 where a single is narrow (≤
    :data:`PACK_WIDTH` bins) or a bundle — skewed features, whose rows the
    histogram kernel sums in registers while they repeat a cell; and the
    decode table ``dec [F, DEC_WIDTH]`` int32 per original feature, which
    :func:`select_bins` reads too."""
    t = layout_tables(layout)
    F = layout.n_features

    def put(a, dtype=torch.int64):
        return _put(a, device, dtype)

    keep = t["sc_feat"] < F
    s_idx, c_idx = np.nonzero(keep)
    own = t["owner"]
    slots = np.full((layout.phys_rows, 3), -1, np.int32)
    slots[:, 2] = 0
    for i, (a, b) in enumerate(layout.pairs):
        slots[i] = (a, b, 1)
    for j, s in enumerate(layout.singles):
        skewed = (layout.widths[s] <= PACK_WIDTH
                  or len(layout.members[s]) > 1)
        slots[layout.packed_rows + j] = (s, -1, int(skewed))
    dec = np.zeros((F, DEC_WIDTH), np.int32)
    dec[:, :DEC_OCC] = np.stack([t["src"][own], t["nib"][own], t["bundled"],
                                 t["off"], t["wid"], t["remap"]], axis=1)
    dec[:, DEC_OCC:DEC_OCC + PACK_WIDTH] = t["occ_pad"]
    d = dict(sc_s=put(s_idx), sc_c=put(c_idx), sc_f=put(t["sc_feat"][keep]),
             sc_b=put(t["sc_bin"][keep]), slots=put(slots, torch.int32),
             dec=put(dec, torch.int32))
    bf = t["bundled_feats"]
    if bf:
        # member m's segment cells (storage owner[m], off[m] + k), k < w−1,
        # and its targets (m, bin_maps[m][j]), j < w, padded to width W
        W = max(int(t["wid"][f]) for f in bf)
        seg_c = np.zeros((len(bf), max(W - 1, 1)), np.int64)
        seg_ok = np.zeros(seg_c.shape, bool)
        tgt_b = np.zeros((len(bf), W), np.int64)
        tgt_ok = np.zeros((len(bf), W), bool)
        for i, f in enumerate(bf):
            w = int(t["wid"][f])
            seg_c[i, :w - 1] = t["off"][f] + np.arange(w - 1)
            seg_ok[i, :w - 1] = True
            tgt_b[i, :w] = layout.bin_maps[f]
            tgt_ok[i, :w] = True
        tgt_f = np.repeat(np.asarray(bf, np.int64)[:, None], W, axis=1)
        d.update(b_s=put(own[list(bf)]), b_w=W, seg_c=put(seg_c),
                 seg_ok=put(seg_ok, torch.bool),
                 tgt_flat=put(np.flatnonzero(tgt_ok)),
                 tgt_f=put(tgt_f[tgt_ok]), tgt_b=put(tgt_b[tgt_ok]))
    return d


@lru_cache(maxsize=16)
def _identity_tables(n_features: int, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    f = np.arange(n_features, dtype=np.int32)
    slots = np.stack([f, np.full_like(f, -1), np.zeros_like(f)], axis=1)
    dec = np.zeros((n_features, DEC_WIDTH), np.int32)
    dec[:, DEC_SRC], dec[:, DEC_NIB] = f, -1
    return _put(slots, device, torch.int32), _put(dec, device, torch.int32)


def kernel_tables(layout: Optional[BinLayout], n_features: int,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slots, dec)``, the tables the CUDA histogram kernels read (see
    :func:`_device_tables`); without a layout the identity — physical row
    f holds feature f at the full byte, undecoded, no runs — so one
    kernel serves the plain ``[F, n]`` matrix and every layout."""
    if layout is None:
        return _identity_tables(n_features, device)
    d = _device_tables(layout, device)
    return d["slots"], d["dec"]


#: shared-memory bytes of one histogram cell of the accumulation kernel:
#: the g and h sums, each as a 32-bit low-digit and a 32-bit high-digit
#: word
CELL_BYTES = 16


def hist_groups(slots: np.ndarray, n_nodes: int, n_bins: int,
                budget: int) -> Tuple[np.ndarray, np.ndarray, bool]:
    """The feature groups of the histogram accumulation kernel, from the
    slot table ``slots [P, 3]`` (:func:`kernel_tables`): ``(rows [P, 4]
    int32, groups [G, 4] int32, shared)``.

    A group is a run ``[p0, p1)`` of consecutive physical rows whose
    cells fit ``budget`` bytes of shared memory (:data:`CELL_BYTES` a
    cell); one block takes one group and reads each row's node and g/h
    once for all of its physical rows.  A slot's cells are ``[N, width +
    1]`` (a pad cell a node puts the nodes' same bin in different
    shared-memory banks): a single has one slot of ``n_bins`` bins, a
    packed row two of 16, a padding row none.  ``groups[g] = (p0, p1,
    cells, 0)``; ``rows[p]`` is the row's slot entry and its first cell
    in its group.  Rows fill groups greedily in order.  Where one
    physical row alone exceeds the budget, ``shared`` is False and the
    one group ``[0, P)`` adds straight into the global histogram (offsets
    0)."""
    slots = np.asarray(slots, np.int64)
    P = slots.shape[0]
    packed = slots[:, 1] >= 0
    width = np.where(packed, PACK_WIDTH, n_bins)
    slot_cells = n_nodes * (width + 1)
    cells = np.where(slots[:, 0] < 0, 0, np.where(packed, 2, 1) * slot_cells)
    rows = np.zeros((P, 4), np.int64)
    rows[:, :3] = slots
    limit = budget // CELL_BYTES
    if P == 0 or cells.max() > limit:
        return (rows.astype(np.int32), np.array([[0, P, 0, 0]], np.int32),
                False)
    groups, p0, used = [], 0, 0
    for p in range(P):
        if used + cells[p] > limit:
            groups.append((p0, p, used, 0))
            p0, used = p, 0
        rows[p, 3] = used
        used += cells[p]
    groups.append((p0, P, used, 0))
    return rows.astype(np.int32), np.array(groups, np.int32), True


def unbundle_hist(hist: torch.Tensor, layout: Optional[BinLayout],
                  n_bins: int) -> torch.Tensor:
    """Storage-space histogram ``[2, N, S, Bs]`` → split-eval histogram
    ``[2, N, F, B]`` in the ORIGINAL feature and bin space.

    Plain storage cells move to their original bin positions.  A bundle
    member's bins slice out of its storage segment; its default bin is
    ``node_total − Σ segment`` in f32, with the total summed in XLA's
    cumsum order and the segment in index order, as the JAX package sums
    them (exact, and so bit-equal, on order-exact g/h)."""
    if layout is None:
        return hist
    t = layout_tables(layout)
    Bs = hist.shape[-1]
    if not layout.has_bundles and not t["any_remap"]:
        if Bs == n_bins:
            return hist
        return torch.nn.functional.pad(hist, (0, n_bins - Bs))
    d = _device_tables(layout, hist.device)
    two, N = hist.shape[:2]
    out = torch.zeros(two, N, layout.n_features, n_bins, dtype=hist.dtype,
                      device=hist.device)
    out[:, :, d["sc_f"], d["sc_b"]] = hist[:, :, d["sc_s"], d["sc_c"]]
    if layout.has_bundles:
        tot = xla_cumsum(hist)[..., -1]                      # [2, N, S]
        seg = torch.where(d["seg_ok"],
                          hist[:, :, d["b_s"][:, None], d["seg_c"]], 0.0)
        seg_sum = torch.zeros_like(seg[..., 0])              # [2, N, nb]
        for k in range(seg.shape[-1]):       # index order; padding adds 0
            seg_sum = seg_sum + seg[..., k]
        b0 = tot[:, :, d["b_s"]] - seg_sum
        col = torch.cat([b0[..., None], seg[..., :d["b_w"] - 1]], dim=-1)
        out[:, :, d["tgt_f"], d["tgt_b"]] = \
            col.reshape(two, N, -1)[:, :, d["tgt_flat"]]
    return out


def select_bins(phys: torch.Tensor, feat_sel: torch.Tensor,
                layout: BinLayout) -> torch.Tensor:
    """Per-row ORIGINAL bin of each row's selected original feature
    ``feat_sel [n]``, read from the physical matrix: the physical byte,
    then nibble extraction, bundle decode and the compact-remap inverse,
    as int32."""
    dec = _device_tables(layout, phys.device)["dec"]
    fs = feat_sel.to(torch.int64)
    raw = phys[dec[:, DEC_SRC].long()[fs],
               torch.arange(phys.shape[1], device=phys.device)
               ].to(torch.int32)
    nib = dec[:, DEC_NIB][fs]
    v = torch.where(nib == 1, raw >> 4,
                    torch.where(nib == 0, raw & 15, raw))
    if layout.has_bundles:
        off, wid = dec[:, DEC_OFF][fs], dec[:, DEC_WID][fs]
        in_seg = (v >= off) & (v < off + wid - 1)
        v = torch.where(dec[:, DEC_BUNDLED][fs] != 0,
                        torch.where(in_seg, v - off + 1, 0), v)
    if layout_tables(layout)["any_remap"]:
        # compact id → ORIGINAL bin id (thresholds are original-space);
        # ids outside the table map to 0, as the reference's 16-way
        # compare-and-sum does
        occ = dec[fs, DEC_OCC + v.clamp(0, PACK_WIDTH - 1).long()]
        orig = torch.where((v >= 0) & (v < PACK_WIDTH), occ, 0)
        v = torch.where(dec[:, DEC_REMAP][fs] != 0, orig, v)
    return v.to(torch.int32)
