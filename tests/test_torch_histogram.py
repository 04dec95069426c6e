"""Port parity of the histogram kernel's plain version (``hist_plain``
behind ``build_histogram`` on a CPU tensor) against the JAX package.

* bf16-exact g/h (g ∈ {±1, ±0.5}, h ∈ {0.5, 1}): BIT-EQUAL to JAX
  ``build_histogram(..., "pallas")`` run in interpret mode — every sum is
  exact in both, so the tolerance is 0;
* general g/h: allclose to ``reference_histogram`` (float64 sums rounded
  once) and to the f32 ``"segment"`` method at rtol 1e-5 / atol 1e-5 — the
  port's fixed-point sum is within one f32 rounding plus 2^-30·max|g| per
  row of the exact sum, the f32 running sums of ``segment`` within ~n ulps.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.ops import histogram as jh  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

# (n, F, n_nodes, n_bins, masked share): masked rows (node −1), n not a
# multiple of anything, N ∈ {1, 2, 4}, F = 5 (not a multiple of 8)
CASES = [
    (1001, 5, 1, 32, 0.1),
    (777, 5, 2, 256, 0.0),
    (1999, 3, 4, 64, 0.25),
    (257, 8, 2, 16, 0.5),
]


def _inputs(n, F, N, B, masked, seed, exact):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, F)).astype(np.uint8)
    node = rng.integers(0, N, n).astype(np.int32)
    node[rng.random(n) < masked] = -1
    if exact:
        g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
        h = rng.choice([0.5, 1.0], n).astype(np.float32)
    else:
        g = rng.normal(size=n).astype(np.float32)
        h = rng.random(n).astype(np.float32)
    return bins, node, g, h


def _port(bins, node, g, h, N, B):
    return th.build_histogram(torch.from_numpy(np.ascontiguousarray(bins.T)),
                              torch.from_numpy(node), torch.from_numpy(g),
                              torch.from_numpy(h), N, B).numpy()


@pytest.mark.parametrize("n,F,N,B,masked", CASES)
def test_bit_equal_to_pallas_kernel_on_exact_gradients(n, F, N, B, masked):
    bins, node, g, h = _inputs(n, F, N, B, masked, seed=n, exact=True)
    want = np.asarray(jh.build_histogram(
        jnp.asarray(np.ascontiguousarray(bins.T)), jnp.asarray(node),
        jnp.asarray(g), jnp.asarray(h), N, B, "pallas", transposed=True))
    got = _port(bins, node, g, h, N, B)
    assert got.shape == (2, N, F, B) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,F,N,B,masked", CASES)
def test_close_to_reference_and_segment_on_general_gradients(n, F, N, B,
                                                             masked):
    bins, node, g, h = _inputs(n, F, N, B, masked, seed=n + 1, exact=False)
    got = _port(bins, node, g, h, N, B)
    ref = jh.reference_histogram(bins, node, g, h, N, B)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    seg = np.asarray(jh.build_histogram(
        jnp.asarray(bins), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), N, B, "segment"))
    np.testing.assert_allclose(got, seg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, th.reference_histogram(
        bins, node, g, h, N, B), rtol=1e-5, atol=1e-5)


def test_sums_do_not_depend_on_row_order():
    # the fixed-point design's point: any order of additions, same bytes
    bins, node, g, h = _inputs(1503, 4, 2, 32, 0.1, seed=3, exact=False)
    perm = np.random.default_rng(9).permutation(len(g))
    a = _port(bins, node, g, h, 2, 32)
    b = _port(bins[perm], node[perm], g[perm], h[perm], 2, 32)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n,vmax", [(1, 1.0), (1503, 0.5), (10_000_000, 1.0),
                                    (1000, 1e-30), (1000, 3e30), (7, 0.0)])
def test_scales_keep_sums_exact_in_float64(n, vmax):
    k = th._scale_exp(vmax, n)
    assert -100 <= k <= 100
    q_max = np.rint(np.float64(np.float32(vmax)) * 2.0 ** k)
    if -100 < k < 100:
        # n rows at the largest |q| stay below 2^53: exact in float64
        assert n * q_max < 2.0 ** 53
        # and the scale keeps at least 2^(52 − bit_length(n)) resolution
        assert q_max >= 2.0 ** (51 - n.bit_length()) or vmax == 0.0


def test_leaves_and_bytes_models_match_jax():
    for depth in (1, 2, 6):
        assert th.leaves_built_per_round(depth) == \
            jh.leaves_built_per_round(depth)
        for fused in (False, True):
            assert th.bins_bytes_per_round(depth, 10_000_000, 28,
                                           fused=fused) == \
                jh.bins_bytes_per_round(depth, 10_000_000, 28, fused=fused)


# ---------------------------------------------------------------------------
# rows whose node id is past the level: dropped, as by the CUDA kernel
# (``if (v >= n_nodes) continue``) and every JAX method
# ---------------------------------------------------------------------------

def _past_level(n, F, N, B, seed):
    """Node ids in ``[-1, 2·N)``: about half the rows lie past the level's
    ``N`` nodes (the one-hot spike's draw), on order-exact g/h."""
    bins, _, g, h = _inputs(n, F, N, B, 0.0, seed=seed, exact=True)
    node = np.random.default_rng(seed + 1).integers(-1, 2 * N, n).astype(
        np.int32)
    assert (node >= N).any() and (node < 0).any()
    return bins, node, g, h


@pytest.mark.parametrize("method", ["pallas", "segment", "matmul"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_node_ids_past_the_level_add_nothing(method, N):
    bins, node, g, h = _past_level(611, 5, N, 32, seed=N)
    want = np.asarray(jh.build_histogram(
        jnp.asarray(np.ascontiguousarray(bins.T)), jnp.asarray(node),
        jnp.asarray(g), jnp.asarray(h), N, 32, method, transposed=True))
    got = _port(bins, node, g, h, N, 32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(th.reference_histogram(
        bins, node, g, h, N, 32), want)


@pytest.mark.parametrize("n_prev", [1, 2])
def test_fused_plain_versions_drop_parents_past_the_level(n_prev):
    # node ids reach 2·n_prev, so the new ids reach 4·n_prev and the left
    # children's parents reach 2·n_prev: the plain fused round and fused
    # descend drop those rows as JAX's kernels do
    B, F, n = 32, 5, 911
    bins, node, g, h = _past_level(n, F, n_prev, B, seed=10 + n_prev)
    bins_t = np.ascontiguousarray(bins.T)
    rng = np.random.default_rng(n_prev)
    feat = rng.integers(0, F, n).astype(np.int32)        # per-row tables
    thr = rng.integers(0, B - 1, n).astype(np.int32)
    prev = jh.build_histogram(jnp.asarray(bins_t), jnp.asarray(node),
                              jnp.asarray(g), jnp.asarray(h), n_prev, B,
                              "pallas", transposed=True)
    nn_j, hist_j, _ = jh.fused_round(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat),
        jnp.asarray(thr), jnp.asarray(g), jnp.asarray(h), prev, n_prev, B)
    nn_t, hist_t, _ = th.fused_round(
        *(torch.from_numpy(a) for a in (bins_t, node, feat, thr, g, h)),
        torch.from_numpy(np.asarray(prev)), n_prev, B)
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
    assert hist_t.numpy().tobytes() == np.asarray(hist_j).tobytes()
    left_j, nn_fj = jh.fused_descend_histogram(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat),
        jnp.asarray(thr), jnp.asarray(g), jnp.asarray(h), n_prev, B,
        fuse=True)
    left_t, nn_ft = th.fused_descend_plain(
        *(torch.from_numpy(a) for a in (bins_t, node, feat, thr, g, h)),
        n_prev, B, *th.hist_scales(torch.from_numpy(g), torch.from_numpy(h)))
    np.testing.assert_array_equal(nn_ft.numpy(), np.asarray(nn_fj))
    assert left_t.numpy().tobytes() == np.asarray(left_j).tobytes()


def test_layout_mode_drops_node_ids_past_the_level():
    from dmlc_core_tpu.ops import binlayout as jbl
    from dmlc_core_tpu_torch.ops import binlayout as tbl

    n, B, N = 1203, 32, 2
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 8, (6, n)).astype(np.uint8)     # narrow: packed
    counts = tbl.bin_counts(torch.from_numpy(bins), B)
    lt = tbl.compute_layout(counts, 6, B, pack=True)
    lj = jbl.compute_layout(counts, 6, B, pack=True)
    assert lt == lj and lt is not None and lt.pairs
    _, node, g, h = _past_level(n, 6, N, B, seed=21)
    phys = jbl.pack_matrix(jnp.asarray(bins), lj)
    got = th.build_histogram(torch.from_numpy(np.asarray(phys)),
                             torch.from_numpy(node), torch.from_numpy(g),
                             torch.from_numpy(h), N, B, layout=lt)
    for method in ("pallas", "segment"):
        want = np.asarray(jh.build_histogram(
            phys, jnp.asarray(node), jnp.asarray(g), jnp.asarray(h), N, B,
            method, transposed=True, layout=lj))
        assert got.numpy().tobytes() == want.tobytes(), method


def test_factored_split_constants_match_jax():
    assert th._TILE_ROWS == jh._TILE_ROWS
    assert th._LO_MEASURED_256 == jh._LO_MEASURED_256
    for n_nodes in (1, 2, 3, 4, 8, 16, 32):
        for n_bins in (2, 16, 64, 255, 256):
            assert th._lo_factor(n_nodes, n_bins) == \
                jh._lo_factor(n_nodes, n_bins)
