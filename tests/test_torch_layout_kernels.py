"""Port parity of the LAYOUT MODES of both histogram kernels (int4-packed
and/or bundled physical matrix, storage-space histograms): the plain
versions behind ``build_histogram(layout=)`` and ``fused_round(layout=)``
on CPU tensors, against the JAX package's ``build_histogram(layout=)``
(``"pallas"`` in interpret mode — the Pallas packed branch — and
``"segment"``) and ``fused_round(layout=)`` (the Pallas round kernel in
interpret mode).

Tolerance 0: g/h are order-exact (g ∈ {±1, ±0.5}, h ∈ {0.5, 1}), so every
sum is exact in both packages, and ``new_node`` is integer work.  The
tables the CUDA kernels read (``slots`` per physical row, the descend's
decode table per original feature) are held on the CPU by emulating the
kernels' per-row arithmetic with numpy.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.ops import binlayout as jbl  # noqa: E402
from dmlc_core_tpu.ops import histogram as jh  # noqa: E402
from dmlc_core_tpu_torch.ops import binlayout as tbl  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

B = 32


def _spread(rng, n, F, narrow):
    bins = np.zeros((F, n), np.uint8)
    for f in range(F):
        if f in narrow:
            k = int(rng.integers(2, 7))
            ids = np.sort(rng.choice(B, size=k, replace=False))
            bins[f] = ids[rng.integers(0, k, n)]
        else:
            bins[f] = (np.arange(n) * (f + 3) + f) % B
    return bins


def _with_bundle(rng, bins, members):
    """Overwrite ``members`` with exclusive one-hots (default not 0)."""
    cat = rng.integers(0, len(members) + 1, bins.shape[1])
    for j, f in enumerate(members):
        bins[f] = np.where(cat == j + 1, 2 + 3 * j, 17 + j)
    return bins


def _case(kind, n, seed):
    """(bins [F, n], port layout, JAX layout) for one layout kind."""
    rng = np.random.default_rng(seed)
    if kind == "packed":
        bins, pack, bundle = _spread(rng, n, 7, (1, 2, 4, 6)), True, False
    elif kind == "bundled":
        bins = _with_bundle(rng, _spread(rng, n, 6, ()), (2, 3, 5))
        pack, bundle = False, True
    else:
        bins = _with_bundle(rng, _spread(rng, n, 9, (0, 3, 7, 8)), (1, 4, 5))
        pack, bundle = True, True
    F = bins.shape[0]
    counts = tbl.bin_counts(torch.from_numpy(bins), B)
    bundles = tbl.detect_bundles(bins, counts, B) if bundle else ()
    lt = tbl.compute_layout(counts, F, B, pack=pack, bundles=bundles)
    lj = jbl.compute_layout(counts, F, B, pack=pack, bundles=bundles)
    assert lt == lj and lt is not None
    assert bool(lt.pairs) == pack and lt.has_bundles == bundle
    return bins, lt, lj


def _gh(rng, n):
    g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
    h = rng.choice([0.5, 1.0], n).astype(np.float32)
    return g, h


def _t(a):
    return torch.from_numpy(np.array(a))


KINDS = ["packed", "bundled", "both"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_nodes", [1, 3])
def test_build_histogram_layout_bit_equal(kind, n_nodes):
    n = 1203
    bins, lt, lj = _case(kind, n, seed=n_nodes)
    rng = np.random.default_rng(7)
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    node[rng.random(n) < 0.1] = -1
    g, h = _gh(rng, n)
    phys = jbl.pack_matrix(jnp.asarray(bins), lj)
    got = th.build_histogram(_t(phys), _t(node), _t(g), _t(h), n_nodes, B,
                             layout=lt)
    assert got.shape == (2, n_nodes, lt.storage_features, lt.sync_bins)
    for method in ("pallas", "segment"):
        want = np.asarray(jh.build_histogram(
            phys, jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
            n_nodes, B, method, transposed=True, layout=lj))
        assert got.numpy().tobytes() == want.tobytes(), method


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_prev", [1, 2, 4])
def test_fused_round_layout_bit_equal(kind, n_prev):
    n = 1203
    bins, lt, lj = _case(kind, n, seed=10 + n_prev)
    rng = np.random.default_rng(n_prev)
    F = bins.shape[0]
    node = rng.integers(0, n_prev, n).astype(np.int32)
    node[rng.random(n) < 0.05] = -1
    feat = rng.integers(0, F, n_prev).astype(np.int32)
    # thresholds inside each feature's occupied range (original bin ids)
    thr = np.array([np.sort(np.unique(bins[f]))[
        rng.integers(0, len(np.unique(bins[f])))] for f in feat], np.int32)
    g, h = _gh(rng, n)
    phys = jbl.pack_matrix(jnp.asarray(bins), lj)
    prev = jh.build_histogram(phys, jnp.asarray(node), jnp.asarray(g),
                              jnp.asarray(h), n_prev, B, "pallas",
                              transposed=True, layout=lj)
    safe = np.maximum(node, 0)
    nn_j, hist_j, _ = jh.fused_round(
        phys, jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), prev,
        n_prev, B, layout=lj)
    S, Bs = lt.storage_features, lt.sync_bins
    for by_node, f_, t_ in ((True, feat, thr),
                            (False, feat[safe], thr[safe])):
        nn_t, hist_t, _ = th.fused_round(
            _t(phys), _t(node), _t(f_), _t(t_), _t(g), _t(h), _t(prev),
            n_prev, B, by_node=by_node, layout=lt)
        np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
        assert hist_t.shape == (2, 2 * n_prev, S, Bs)
        assert hist_t.numpy().tobytes() == np.asarray(hist_j).tobytes()
    # the descend decodes to ORIGINAL bins: same routing as the plain
    # matrix would give
    plain = th.descend_plain(_t(bins), _t(node), _t(feat), _t(thr))
    np.testing.assert_array_equal(nn_t.numpy(), plain.numpy())


def _emulate_kernels(bins, lt, n, seed):
    """numpy emulation of the CUDA kernels' per-row work, from the tables
    the wrappers pass them (``binlayout.kernel_tables``): equal to the
    plain versions."""
    F = bins.shape[0]
    slots, dec = tbl.kernel_tables(lt, F, torch.device("cpu"))
    slots, dec = slots.numpy(), dec.numpy()
    assert dec.shape == (F, tbl.DEC_WIDTH) and slots.shape[1] == 3
    phys = (bins if lt is None
            else tbl.pack_matrix(torch.from_numpy(bins), lt).numpy())
    rng = np.random.default_rng(seed)
    node = rng.integers(-1, 2, n).astype(np.int32)
    g, h = _gh(rng, n)
    S, Bs = (F, B) if lt is None else (lt.storage_features, lt.sync_bins)
    # hist_accum_kernel: per physical row, its (lo, hi) slots
    acc = np.zeros((2, 2, S, Bs))
    rows = np.nonzero(node >= 0)[0]
    for p, (lo, hi, runs) in enumerate(slots):
        if lo < 0:
            assert runs == 0
            continue                              # padding row
        # register runs on the skewed rows: packed pairs, narrow singles,
        # bundles; never without a layout
        assert runs == (lt is not None and (
            hi >= 0 or lt.widths[lo] <= tbl.PACK_WIDTH
            or len(lt.members[lo]) > 1))
        parts = ([(lo, phys[p] & 15), (hi, phys[p] >> 4)] if hi >= 0
                 else [(lo, phys[p])])
        for s, v in parts:
            np.add.at(acc[0], (node[rows], s, v[rows]), g[rows])
            np.add.at(acc[1], (node[rows], s, v[rows]), h[rows])
    kg, kh = th.hist_scales(_t(g), _t(h))
    want = th.hist_plain(_t(phys), _t(node), _t(g), _t(h), 2, B, kg, kh, lt)
    np.testing.assert_array_equal(acc.astype(np.float32), want.numpy())
    # descend_kernel: decode each row's feature through dec
    feat = rng.integers(0, F, n)
    got = np.empty(n, np.int64)
    for r in range(n):
        d = dec[feat[r]]
        v = int(phys[d[tbl.DEC_SRC], r])
        nib = d[tbl.DEC_NIB]
        v = v >> 4 if nib == 1 else (v & 15 if nib == 0 else v)
        if d[tbl.DEC_BUNDLED]:
            off, wid = d[tbl.DEC_OFF], d[tbl.DEC_WID]
            v = v - off + 1 if off <= v < off + wid - 1 else 0
        if d[tbl.DEC_REMAP]:
            v = d[tbl.DEC_OCC + v] if 0 <= v < tbl.PACK_WIDTH else 0
        got[r] = v
    np.testing.assert_array_equal(got, bins[feat, np.arange(n)])


@pytest.mark.parametrize("kind", KINDS + ["none"])
def test_kernel_tables_drive_the_kernels_arithmetic(kind):
    """Every layout kind, and the identity tables of the plain [F, n]
    matrix (no layout), through the one kernel's arithmetic."""
    n = 997
    if kind == "none":
        bins, lt = _spread(np.random.default_rng(3), n, 5, (1, 3)), None
    else:
        bins, lt, _ = _case(kind, n, seed=3)
    _emulate_kernels(bins, lt, n, seed=5)


def _wide_case(n, seed):
    """F = 300: 20 wide columns and 280 one-hot columns in 14 groups of 20
    (mutually exclusive within a group) — more features than one byte of
    feature ids, as wide one-hot data has."""
    rng = np.random.default_rng(seed)
    bins = np.zeros((300, n), np.uint8)
    for f in range(20):
        bins[f] = rng.integers(0, B, n)
    for grp in range(14):
        cat = rng.integers(0, 21, n)
        for j in range(20):
            bins[20 + 20 * grp + j] = cat == j + 1
    counts = tbl.bin_counts(torch.from_numpy(bins), B)
    bundles = tbl.detect_bundles(bins, counts, B)
    lt = tbl.compute_layout(counts, 300, B, pack=True, bundles=bundles)
    lj = jbl.compute_layout(counts, 300, B, pack=True, bundles=bundles)
    assert lt == lj and lt.has_bundles
    return bins, lt, lj


def test_more_than_256_features():
    """A layout over 300 original features: the decode table has a row
    for each, the kernels' arithmetic holds, and the plain fused round
    equals the JAX package's."""
    n = 517
    bins, lt, lj = _wide_case(n, seed=4)
    _emulate_kernels(bins, lt, n, seed=6)
    rng = np.random.default_rng(8)
    n_prev = 2
    node = rng.integers(0, n_prev, n).astype(np.int32)
    feat = np.array([7, 257], np.int32)               # wide, bundled
    thr = np.array([B // 2, 0], np.int32)
    g, h = _gh(rng, n)
    phys = jbl.pack_matrix(jnp.asarray(bins), lj)
    prev = jh.build_histogram(phys, jnp.asarray(node), jnp.asarray(g),
                              jnp.asarray(h), n_prev, B, "segment",
                              transposed=True, layout=lj)
    nn_j, hist_j, _ = jh.fused_round(
        phys, jnp.asarray(node), jnp.asarray(feat[node]),
        jnp.asarray(thr[node]), jnp.asarray(g), jnp.asarray(h), prev,
        n_prev, B, layout=lj)
    nn_t, hist_t, _ = th.fused_round(
        _t(phys), _t(node), _t(feat), _t(thr), _t(g), _t(h), _t(prev),
        n_prev, B, by_node=True, layout=lt)
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
    assert hist_t.numpy().tobytes() == np.asarray(hist_j).tobytes()
    # both sides of each split are taken
    assert set(np.unique(nn_t.numpy() % 2)) == {0, 1}


def test_kernel_wrappers_refuse_cpu_tensors():
    bins, lt, _ = _case("packed", 64, seed=1)
    phys = tbl.pack_matrix(torch.from_numpy(bins), lt)
    z = torch.zeros(64)
    with pytest.raises(Exception, match="CUDA"):
        th.hist_kernel(phys, torch.zeros(64, dtype=torch.int32), z, z, 1, B,
                       0, 0, layout=lt)
