"""The feature groups and the digit arithmetic of the port's histogram
accumulation kernel (``binlayout.hist_groups`` and ``histogram.
_accum_plan``, read by ``hist_accum_kernel`` in
``dmlc_core_tpu_torch/ops/csrc/histogram.cu``).

The kernel cannot run on the CPU.  A numpy emulation of its grouped
scatter, driven by nothing but the plan (each group's physical rows ``[p0,
p1)``, each row's slot entry and first cell, the row chunks and the digit
split), is held bit for bit to the plain versions ``hist_plain``
and ``_accum_plain``: per (group, row chunk) block a shared histogram of
32-bit words, each row's fixed-point g/h as a low digit (unsigned) and a
high digit (signed) summed apart, asserted never to leave its word, then
one int64 add per nonzero cell into the global histogram.  Rows past the
digits' range, and every row past the shared budget, add straight into
the global histogram.  Cases: the plain ``[F, n]`` matrix and the
physical matrices of configurations 2a (int4 pairs and a bundle) and 2b
(int4 pairs only), 1, 2 and 16 nodes, ``left_only`` on and off, the
scales of ``hist_scales`` and larger ones, on an H100 and on cards whose
shared memory splits the rows into several groups or fits no row.
"""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.ops import binlayout as tbl
from dmlc_core_tpu_torch.ops import histogram as th

torch.set_num_threads(2)

B = 64
#: shared bytes an H100 block may opt in to
H100_BUDGET = 232_448


def _spread(rng, n, F, narrow):
    bins = np.zeros((F, n), np.uint8)
    for f in range(F):
        if f in narrow:
            k = int(rng.integers(2, 7))
            ids = np.sort(rng.choice(B, size=k, replace=False))
            bins[f] = ids[rng.integers(0, k, n)]
        else:
            bins[f] = rng.integers(0, B, n)
    return bins


def _with_bundle(rng, bins, members):
    """Overwrite ``members`` with exclusive one-hots (default not 0)."""
    cat = rng.integers(0, len(members) + 1, bins.shape[1])
    for j, f in enumerate(members):
        bins[f] = np.where(cat == j + 1, 2 + 3 * j, 17 + j)
    return bins


def _case(kind, n, seed):
    """(physical matrix [P, n], layout or None): the plain matrix, 2a
    (pack + bundle) or 2b (pack only)."""
    rng = np.random.default_rng(seed)
    if kind == "plain":
        return _spread(rng, n, 6, ()), None
    if kind == "2a":
        bins = _with_bundle(rng, _spread(rng, n, 9, (0, 3, 7, 8)), (1, 4, 5))
        pack, bundle = True, True
    else:
        bins, pack, bundle = _spread(rng, n, 7, (1, 2, 4, 6)), True, False
    F = bins.shape[0]
    counts = tbl.bin_counts(torch.from_numpy(bins), B)
    bundles = tbl.detect_bundles(bins, counts, B) if bundle else ()
    lt = tbl.compute_layout(counts, F, B, pack=pack, bundles=bundles)
    assert lt is not None and bool(lt.pairs) and lt.has_bundles == bundle
    return tbl.pack_matrix(torch.from_numpy(bins), lt).numpy(), lt


def _inputs(n, n_nodes, seed):
    rng = np.random.default_rng(seed)
    node = rng.integers(-1, 2 * n_nodes + 1, n).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    return node, g, h


#: (SMs, shared bytes a block may opt in to, of an SM, reserved a block):
#: an H100, and a card small enough to split the rows into several groups
#: or to fit no row at all (the global-atomic instantiation)
H100 = (132, H100_BUDGET, 233_472, 1_024)


def _small(phys, layout, n_nodes, rows_per_group):
    """A card whose blocks hold about ``rows_per_group`` physical rows'
    cells (0: not one) besides the group table."""
    Bs = B if layout is None else layout.sync_bins
    row = n_nodes * max(Bs + 1, 2 * (tbl.PACK_WIDTH + 1)) * tbl.CELL_BYTES
    table = th.TABLE_ENTRY_BYTES * phys.shape[0]
    return (3, rows_per_group * row + table + 16, 233_472, 0)


def _emulate(phys, node, g, h, layout, n_nodes, n_bins, kg, kh, left_only,
             limits):
    """The kernel's grouped scatter under the plan ``_accum_plan`` gives
    for a card of ``limits``: int64 ``[2, n_nodes, S, n_bins]`` (wrapping
    mod 2^64) from the group table and the digit split alone.  Asserts
    that every block's digit sums stay in their 32-bit words."""
    P, n = phys.shape
    S = P if layout is None else layout.storage_features
    plan = th._accum_plan(layout, P if layout is None else layout.n_features,
                          n, n_nodes, n_bins, limits)
    rows, groups, shared = plan.rows, plan.groups, plan.shared
    assert plan.rows_per_chunk % 4 == 0
    assert plan.chunks * plan.rows_per_chunk >= n
    if shared:
        assert plan.rows_per_chunk <= 2 ** (32 - plan.shift)
        assert 2 * (32 - plan.shift) <= 63 - plan.qbits
    v = node.astype(np.int64)
    if left_only:
        v = np.where((v >= 0) & (v % 2 == 0), v >> 1, -1)
    v = np.where(v < n_nodes, v, -1)
    q = [th._quantize(torch.from_numpy(a), k).numpy() for a, k in
         ((g, kg), (h, kh))]
    lim = 2 ** plan.qbits
    fits = ((q[0] >= -lim) & (q[0] < lim) & (q[1] >= -lim)
            & (q[1] < lim))
    out = np.zeros((2, n_nodes * S * n_bins), np.uint64)

    def add_global(idx, rr):
        for k in range(2):
            np.add.at(out[k], idx, q[k][rr].view(np.uint64))

    for p0, p1, cells, _ in groups:
        for c0 in range(0, n, plan.rows_per_chunk):
            r = np.arange(c0, min(n, c0 + plan.rows_per_chunk))
            r = r[v[r] >= 0]
            fast = r[fits[r]] if shared else r[:0]
            wide = r[~fits[r]] if shared else r
            # [g/h, cells] sums of the low and the high digits, in int64
            lo = np.zeros((2, max(cells, 1)), np.int64)
            hi = np.zeros((2, max(cells, 1)), np.int64)
            for p in range(p0, p1):
                s_lo, s_hi, _, off = rows[p]
                width = tbl.PACK_WIDTH if s_hi >= 0 else n_bins
                slot_cells = n_nodes * (width + 1)
                if s_lo < 0:
                    continue
                for rr, into_shared in ((fast, True), (wide, False)):
                    b = phys[p, rr].astype(np.int64)
                    parts = ([(0, b & 15), (1, b >> 4)] if s_hi >= 0
                             else [(0, b)])
                    for slot, bin_ in parts:
                        ok = bin_ < n_bins
                        r2, bb = rr[ok], bin_[ok]
                        if not into_shared:
                            s = s_hi if slot else s_lo
                            add_global((v[r2] * S + s) * n_bins + bb, r2)
                            continue
                        cell = (off + slot * slot_cells
                                + v[r2] * (width + 1) + bb)
                        assert cell.max(initial=-1) < cells
                        for k in range(2):
                            qk = q[k][r2]
                            np.add.at(lo[k], cell, qk & (2 ** plan.shift - 1))
                            np.add.at(hi[k], cell, qk >> plan.shift)
            if not shared:
                continue
            # each digit sum fits its 32-bit word: no wrap, exact
            assert lo.min() >= 0 and lo.max() < 2 ** 32
            assert hi.min() >= -2 ** 31 and hi.max() < 2 ** 31
            val = (lo + (hi << plan.shift)).view(np.uint64)
            # the flush: each nonzero cell's int64 into the global
            # histogram at (node, storage feature, bin)
            for p in range(p0, p1):
                s_lo, s_hi, _, off = rows[p]
                width = tbl.PACK_WIDTH if s_hi >= 0 else n_bins
                slot_cells = n_nodes * (width + 1)
                if s_lo < 0:
                    continue
                c = np.arange((2 if s_hi >= 0 else 1) * slot_cells)
                slot, rem = c // slot_cells, c % slot_cells
                nd, bin_ = rem // (width + 1), rem % (width + 1)
                s = np.where(slot == 1, s_hi, s_lo)
                idx = (nd * S + s) * n_bins + bin_
                keep = (val[0, off + c] | val[1, off + c]) != 0
                for k in range(2):
                    np.add.at(out[k], idx[keep], val[k, off + c][keep])
    return out.view(np.int64).reshape(2, n_nodes, S, n_bins), plan


def _check_groups(phys, layout, n_nodes, n_bins, budget):
    """Every non-padding physical row in exactly one group, groups in
    order and each within its budget; returns ``shared``."""
    P = phys.shape[0]
    slots, _ = tbl.kernel_tables(layout, P if layout is None
                                 else layout.n_features, torch.device("cpu"))
    slots = slots.numpy()
    rows, groups, shared = tbl.hist_groups(slots, n_nodes, n_bins, budget)
    np.testing.assert_array_equal(rows[:, :3], slots)
    seen = np.zeros(P, np.int64)
    for p0, p1, cells, _ in groups:
        seen[p0:p1] += 1
        if not shared:
            continue
        assert cells * tbl.CELL_BYTES <= budget
        used = 0
        for p in range(p0, p1):
            s_lo, s_hi, _, off = rows[p]
            if s_lo < 0:
                continue
            assert off == used
            width = tbl.PACK_WIDTH if s_hi >= 0 else n_bins
            used += (2 if s_hi >= 0 else 1) * n_nodes * (width + 1)
        assert used == cells
    assert np.array_equal(groups[1:, 0], groups[:-1, 1])
    assert groups[0, 0] == 0 and groups[-1, 1] == P
    real = slots[:, 0] >= 0
    assert (seen[real] == 1).all()
    return shared, len(groups)


@pytest.mark.parametrize("left_only", [False, True])
@pytest.mark.parametrize("n_nodes", [1, 2, 16])
@pytest.mark.parametrize("kind", ["plain", "2a", "2b"])
def test_grouped_scatter_equals_plain(kind, n_nodes, left_only):
    n = 1001
    phys, lt = _case(kind, n, seed=n_nodes)
    node, g, h = _inputs(n, n_nodes, seed=3 + n_nodes)
    n_bins = B if lt is None else lt.sync_bins
    kg, kh = th.hist_scales(torch.from_numpy(g), torch.from_numpy(h))
    t = torch.from_numpy
    kinds = set()
    # the scales hist_scales gives, and g's 2^12 times larger: rows past
    # the digits' range, added whole
    for bump in (0, 12):
        want = th.hist_plain(t(phys), t(node), t(g), t(h), n_nodes, B,
                             kg + bump, kh, lt, left_only=left_only)
        # _accum_plain's int64 sums over the rows that add (storage space)
        v = th._left_children(t(node)) if left_only else t(node)
        keep = torch.nonzero((v >= 0) & (v < n_nodes)).squeeze(1)
        store = t(phys)[:, keep]
        if lt is not None:
            store = tbl.unpack_matrix(store, lt)
        acc = th._accum_plain(store, v[keep], t(g)[keep], t(h)[keep],
                              n_nodes, n_bins, kg + bump, kh).numpy()
        for limits in (H100, _small(phys, lt, n_nodes, 2),
                       _small(phys, lt, n_nodes, 0)):
            budget = limits[1] - th.TABLE_ENTRY_BYTES * phys.shape[0]
            shared, n_groups = _check_groups(phys, lt, n_nodes, n_bins,
                                             budget)
            got, plan = _emulate(phys, node, g, h, lt, n_nodes, n_bins,
                                 kg + bump, kh, left_only, limits)
            assert (plan.shared, len(plan.groups)) == (shared, n_groups)
            np.testing.assert_array_equal(got.reshape(2, -1), acc)
            hist = np.stack([th._dequantize(t(got[0]), kg + bump).numpy(),
                             th._dequantize(t(got[1]), kh).numpy()])
            assert hist.tobytes() == want.numpy().tobytes()
            kinds.add((shared, n_groups > 1))
    # one group, several groups, and past the budget all ran
    assert (False, False) in kinds and (True, True) in kinds


@pytest.mark.parametrize("kind", ["plain", "2a", "2b"])
def test_flagship_plans_on_the_h100(kind):
    """10M rows: n_prev 1 at 256 bins is one group (the whole
    28-feature histogram, 112 KB) in one wave of 132 chunks; 16 nodes
    make groups of three features; 64 nodes add into global memory.
    Every plan keeps a block's digit sums in range."""
    n = 10_000_000
    if kind != "plain":
        phys, lt = _case(kind, 64, seed=0)
        plan = th._accum_plan(lt, lt.n_features, n, 1, lt.sync_bins, H100)
        assert plan.shared and len(plan.groups) == 1
        return
    for n_nodes in (1, 2, 4, 8, 16, 32, 64, 2048):
        plan = th._accum_plan(None, 28, n, n_nodes, 256, H100)
        L = 32 - plan.shift
        assert plan.qbits == 53 - n.bit_length() and 2 * L <= 63 - plan.qbits
        assert plan.rows_per_chunk % 4 == 0
        assert plan.chunks * plan.rows_per_chunk >= n
        if n_nodes == 1:
            assert plan.groups.tolist() == [[0, 28, 28 * 257, 0]]
            assert plan.chunks == 132 and plan.rows_per_chunk <= 2 ** L
        if n_nodes == 16:
            assert (plan.groups[:, 1] - plan.groups[:, 0]).max() == 3
        assert plan.shared == (n_nodes < 64)
        if plan.shared:
            assert plan.rows_per_chunk <= 2 ** L
            assert plan.smem <= H100_BUDGET
            # with one block an SM, chunks x groups fill its waves
            blocks = plan.chunks * len(plan.groups)
            waves = -(-blocks // 132)
            assert blocks >= 0.9 * waves * 132


def test_digit_sums_stay_exact_at_the_bound():
    """Every row at the largest |q| the scales allow, all in one cell:
    the digit sums reach their words' limits and stay exact."""
    n = 4096
    phys = np.zeros((1, n), np.uint8)
    node = np.zeros(n, np.int32)
    g = np.full(n, -1.0, np.float32)
    g[::2] = 0.99999994
    h = np.full(n, 0.999, np.float32)
    kg, kh = th.hist_scales(torch.from_numpy(g), torch.from_numpy(h))
    got, plan = _emulate(phys, node, g, h, None, 1, 4, kg, kh, False, H100)
    assert plan.shared
    t = torch.from_numpy
    acc = th._accum_plain(t(phys), t(node), t(g), t(h), 1, 4, kg,
                          kh).numpy()
    np.testing.assert_array_equal(got.reshape(2, -1), acc)
