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
