"""Port parity of ``dmlc_core_tpu_torch.ops.binlayout`` against the JAX
package's ``dmlc_core_tpu.ops.binlayout``, mirroring tests/test_binpack.py.

Tolerance 0 throughout: the layout decisions are integer/numpy work, the
packed matrix is bytes, and ``unbundle_hist`` is compared on order-exact
histograms (sums of ±1, ±0.5 and 0.5, 1), where its f32 default-bin
reconstruction ``total − Σ segment`` is exact in both packages.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.ops import binlayout as jbl  # noqa: E402
from dmlc_core_tpu.ops.histogram import build_histogram  # noqa: E402
from dmlc_core_tpu_torch.ops import binlayout as tbl  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)


def _spread_bins(rng, n, F, B, narrow=()):
    """[F, n] bin matrix like the eps-bumped sketch's: narrow features
    occupy FEW, SPREAD-OUT ids; wide features cover every bin."""
    bins = np.zeros((F, n), np.uint8)
    for f in range(F):
        if f in narrow:
            k = int(rng.integers(2, 7))
            ids = np.sort(rng.choice(B, size=k, replace=False))
            bins[f] = ids[rng.integers(0, k, n)]
        else:
            bins[f] = (np.arange(n) + f) % B
    return bins


def _exclusive_bins(rng, n, B=32):
    """Two near-one-hot features whose DEFAULT bin is not 0, plus a wide
    feature; the one-hots never fire on the same row."""
    bins = np.zeros((3, n), np.uint8)
    bins[0] = np.arange(n) % B
    onehot = rng.integers(0, 3, n)
    bins[1] = np.where(onehot == 1, 20, 5)
    bins[2] = np.where(onehot == 2, 25, 7)
    return bins


def _mixed_bins(rng, n, B=32):
    """Both levers at once: a bundle of three exclusive one-hots, four
    narrow non-exclusive features (two int4 pairs) and two wide ones."""
    bins = _spread_bins(rng, n, 9, B, narrow=(1, 2, 3, 4))
    cat = rng.integers(0, 4, n)
    for j, f in enumerate((5, 6, 7)):
        bins[f] = np.where(cat == j + 1, 3 + 2 * j, 9 + j)
    return bins


def _counts(bins, B):
    return tbl.bin_counts(torch.from_numpy(bins), B)


def _layouts(bins, B, pack=True, bundle=False):
    """(port layout, JAX layout) of ``bins`` through each package."""
    ct = _counts(bins, B)
    cj = np.asarray(jbl.bin_counts(jnp.asarray(bins), B))
    bt = tbl.detect_bundles(bins, ct, B) if bundle else ()
    bj = jbl.detect_bundles(bins, cj, B) if bundle else ()
    assert bt == bj
    F = bins.shape[0]
    return (tbl.compute_layout(ct, F, B, pack=pack, bundles=bt),
            jbl.compute_layout(cj, F, B, pack=pack, bundles=bj))


CASES = {
    "packed": lambda rng: (_spread_bins(rng, 1021, 9, 32,
                                        narrow=(1, 4, 7, 8)), True, False),
    "bundled": lambda rng: (_exclusive_bins(rng, 1021), False, True),
    "both": lambda rng: (_mixed_bins(rng, 1203), True, True),
}


def test_bin_counts_match_and_mask_padding(rng):
    bins = _spread_bins(rng, 500, 3, 32, narrow=(1,))
    np.testing.assert_array_equal(
        _counts(bins, 32), np.asarray(jbl.bin_counts(jnp.asarray(bins), 32)))
    padded = np.concatenate([bins, np.zeros((3, 36), np.uint8)], axis=1)
    assert _counts(bins, 32).dtype == np.int32
    np.testing.assert_array_equal(
        tbl.bin_counts(torch.from_numpy(padded), 32, n_valid=500),
        _counts(bins, 32))
    np.testing.assert_array_equal(
        tbl.used_bin_widths(torch.from_numpy(bins)),
        jbl.used_bin_widths(jnp.asarray(bins)))


def test_all_wide_is_trivial(rng):
    bins = _spread_bins(rng, 500, 4, 32, narrow=())
    assert tbl.compute_layout(_counts(bins, 32), 4, 32) is None


def test_pack_off_is_trivial(rng):
    bins = _spread_bins(rng, 500, 6, 32, narrow=(1, 3, 5))
    assert tbl.compute_layout(_counts(bins, 32), 6, 32, pack=False) is None


def test_narrow_features_pair(rng):
    bins = _spread_bins(rng, 500, 9, 32, narrow=(1, 4, 7, 8))
    lt, lj = _layouts(bins, 32)
    assert lt == lj
    assert len(lt.pairs) == 2 and lt.storage_features == 9
    assert lt.sync_bins == 32 and lt.packed_rows == 8 and lt.phys_rows == 13
    for f in (1, 4, 7, 8):
        assert set(lt.bin_maps[f]) == set(np.unique(bins[f]))


def test_conflicting_features_not_bundled(rng):
    n, B = 800, 32
    bins = np.zeros((2, n), np.uint8)
    bins[0] = np.where(rng.random(n) < 0.3, 20, 5)
    bins[1] = np.where(rng.random(n) < 0.3, 25, 7)      # overlaps feat 0
    counts = _counts(bins, B)
    assert tbl.detect_bundles(bins, counts, B) == ()
    assert jbl.detect_bundles(bins, counts, B) == ()


def test_bundle_defaults_lead_the_maps(rng):
    bins = _exclusive_bins(rng, 1021)
    lt, lj = _layouts(bins, 32, pack=False, bundle=True)
    assert lt == lj and lt.has_bundles and lt.storage_features == 2
    assert lt.bin_maps[1][0] == 5 and lt.bin_maps[2][0] == 7


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_tables_equal(case, rng):
    bins, pack, bundle = CASES[case](rng)
    lt, lj = _layouts(bins, 32, pack, bundle)
    assert lt is not None and lt == lj
    tt, tj = tbl.layout_tables(lt), jbl.layout_tables(lj)
    assert sorted(tt) == sorted(tj)
    for key in tj:
        if isinstance(tj[key], np.ndarray):
            assert tt[key].dtype == tj[key].dtype, key
            np.testing.assert_array_equal(tt[key], tj[key], err_msg=key)
        else:
            assert tt[key] == tj[key], key


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_unpack_select_byte_equal(case, rng):
    bins, pack, bundle = CASES[case](rng)
    lt, lj = _layouts(bins, 32, pack, bundle)
    phys_t = tbl.pack_matrix(torch.from_numpy(bins), lt)
    phys_j = np.asarray(jbl.pack_matrix(jnp.asarray(bins), lj))
    assert phys_t.dtype == torch.uint8 and phys_t.shape[0] == lt.phys_rows
    np.testing.assert_array_equal(phys_t.numpy(), phys_j)
    np.testing.assert_array_equal(
        tbl.unpack_matrix(phys_t, lt).numpy(),
        np.asarray(jbl.unpack_matrix(jnp.asarray(phys_j), lj)))
    n = bins.shape[1]
    # every original feature decodes back to its original bins
    for f in range(bins.shape[0]):
        got = tbl.select_bins(phys_t, torch.full((n,), f), lt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), bins[f], err_msg=str(f))
    # a per-row mix of features, against the JAX decode
    sel = rng.integers(0, bins.shape[0], n).astype(np.int32)
    np.testing.assert_array_equal(
        tbl.select_bins(phys_t, torch.from_numpy(sel), lt).numpy(),
        np.asarray(jbl.select_bins(jnp.asarray(phys_j), jnp.asarray(sel),
                                   lj)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_unbundle_hist_bit_equal(case, rng):
    bins, pack, bundle = CASES[case](rng)
    lt, lj = _layouts(bins, 32, pack, bundle)
    n, N = bins.shape[1], 3
    node = rng.integers(0, N, n).astype(np.int32)
    node[::7] = -1
    g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
    h = rng.choice([0.5, 1.0], n).astype(np.float32)
    phys = jbl.pack_matrix(jnp.asarray(bins), lj)
    hs = build_histogram(phys, jnp.asarray(node), jnp.asarray(g),
                         jnp.asarray(h), N, 32, "segment", transposed=True,
                         layout=lj)
    want = np.asarray(jbl.unbundle_hist(hs, lj, 32))
    got = tbl.unbundle_hist(torch.from_numpy(np.array(hs)), lt, 32)
    assert got.shape == want.shape == (2, N, bins.shape[0], 32)
    assert got.numpy().tobytes() == want.tobytes()
    # and both equal the plain build of the original matrix
    plain = np.asarray(build_histogram(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), N, 32, "segment", transposed=True))
    np.testing.assert_array_equal(got.numpy(), plain)


def test_unbundle_without_layout_is_identity():
    hist = torch.arange(2 * 1 * 3 * 8, dtype=torch.float32).reshape(2, 1, 3, 8)
    assert tbl.unbundle_hist(hist, None, 8) is hist
