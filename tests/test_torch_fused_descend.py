"""Port parity of the fused descend (``fused_descend_histogram`` with
``fuse=True``: the plain version ``fused_descend_plain`` on CPU tensors)
against the JAX package's ``_fused_pallas`` (the Pallas ``_fused_kernel``
in interpret mode, as tests/test_models.py runs it) and its unfused
chain.

``new_node`` is integer work: equal.  Histograms are bit-equal on
order-exact g/h (g ∈ {±1, ±0.5}, h ∈ {0.5, 1}: every sum is exact in
both packages).  On general g/h they are held to JAX's ``fuse=False``
``"segment"`` chain at rtol 1e-5, atol 1e-5: that chain sums f32 in
scatter order, the port in fixed point (one rounding at the end), so the
two differ by a few ulps of a cell's sum.  The TPU kernel itself rounds
g/h to bf16, so it is not the yardstick on general g/h.
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


def _level(n, F, n_prev, seed, exact):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, B, (F, n)).astype(np.uint8)
    node = rng.integers(0, n_prev, n).astype(np.int32)
    node[rng.random(n) < 0.05] = -1
    feat = rng.integers(0, F, n_prev).astype(np.int32)
    thr = rng.integers(0, B - 1, n_prev).astype(np.int32)
    if exact:
        g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
        h = rng.choice([0.5, 1.0], n).astype(np.float32)
    else:
        g = rng.normal(size=n).astype(np.float32)
        h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return bins_t, node, feat, thr, g, h


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(bins_t, node, feat, thr, g, h, n_prev, fuse=True, by_node=False,
          **kw):
    left, nn = th.fused_descend_histogram(
        _t(bins_t), _t(node), _t(feat), _t(thr), _t(g), _t(h), n_prev, B,
        fuse=fuse, by_node=by_node, **kw)
    return left.numpy(), nn.numpy()


@pytest.mark.parametrize("F", [5, 11])
@pytest.mark.parametrize("n_prev", [1, 2, 4, 8])
def test_matches_jax_fused_kernel_bit_exact(n_prev, F):
    n = 1500
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=n_prev + F,
                                           exact=True)
    safe = np.maximum(node, 0)
    hist_j, nn_j = jh._fused_pallas(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), n_prev, B)
    # per-row split arrays (JAX's form) and per-node tables (training's)
    for f_, t_, by_node in ((feat[safe], thr[safe], False),
                            (feat, thr, True)):
        left, nn = _port(bins_t, node, f_, t_, g, h, n_prev,
                         by_node=by_node)
        np.testing.assert_array_equal(nn, np.asarray(nn_j))
        assert left.shape == (2, n_prev, F, B)
        np.testing.assert_array_equal(left.view(np.uint32),
                                      np.asarray(hist_j).view(np.uint32))
    assert (nn[node < 0] == -1).all()


@pytest.mark.parametrize("n_prev", [1, 4])
def test_general_gh_close_to_jax_unfused_chain(n_prev):
    n, F = 2000, 7
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=40 + n_prev,
                                           exact=False)
    safe = np.maximum(node, 0)
    hist_j, nn_j = jh.fused_descend_histogram(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), n_prev, B,
        "segment", fuse=False)
    left, nn = _port(bins_t, node, feat, thr, g, h, n_prev, by_node=True)
    np.testing.assert_array_equal(nn, np.asarray(nn_j))
    np.testing.assert_allclose(left, np.asarray(hist_j), rtol=1e-5,
                               atol=1e-5)
    # the fused and unfused forms of the port are the same function
    left_u, nn_u = _port(bins_t, node, feat, thr, g, h, n_prev, fuse=False,
                         by_node=True)
    np.testing.assert_array_equal(nn_u, nn)
    np.testing.assert_array_equal(left_u.view(np.uint32),
                                  left.view(np.uint32))


def test_missing_direction_takes_the_unfused_chain():
    n, F, n_prev = 1200, 6, 4
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=7, exact=True)
    rng = np.random.default_rng(8)
    bins_t[:, rng.random(n) < 0.2] = B - 1          # the missing bin
    dirv = rng.integers(0, 2, n_prev).astype(np.int32)
    safe = np.maximum(node, 0)
    hist_j, nn_j = jh.fused_descend_histogram(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), n_prev, B,
        "segment", fuse=True, dir_sel=jnp.asarray(dirv[safe]),
        miss_bin=B - 1)
    for d_, f_, t_, by_node in ((dirv[safe], feat[safe], thr[safe], False),
                                (dirv, feat, thr, True)):
        left, nn = _port(bins_t, node, f_, t_, g, h, n_prev, by_node=by_node,
                         dir_sel=_t(d_), miss_bin=B - 1)
        np.testing.assert_array_equal(nn, np.asarray(nn_j))
        np.testing.assert_array_equal(left.view(np.uint32),
                                      np.asarray(hist_j).view(np.uint32))
    # the direction really routes: without it the missing rows follow thr
    _, nn_thr = _port(bins_t, node, feat, thr, g, h, n_prev, by_node=True)
    assert not np.array_equal(nn_thr, nn)


def test_layout_takes_the_unfused_chain():
    # a packed + bundled layout: int4 pairs of narrow features and a
    # bundle of exclusive one-hots; the split tables name ORIGINAL
    # features and bins
    rng = np.random.default_rng(3)
    n, F, n_prev = 1500, 8, 2
    bins = np.zeros((F, n), np.uint8)
    for f in range(F):
        bins[f] = rng.integers(0, 4 if f in (1, 2) else B, n)
    cat = rng.integers(0, 4, n)
    for j, f in enumerate((4, 5, 6)):
        bins[f] = np.where(cat == j + 1, 1, 0)
    counts = tbl.bin_counts(torch.from_numpy(bins), B)
    bundles = tbl.detect_bundles(bins, counts, B)
    lt = tbl.compute_layout(counts, F, B, pack=True, bundles=bundles)
    lj = jbl.compute_layout(counts, F, B, pack=True, bundles=bundles)
    assert lt == lj and lt.pairs and lt.has_bundles
    phys_t = tbl.pack_matrix(torch.from_numpy(bins), lt)
    phys_j = jbl.pack_matrix(jnp.asarray(bins), lj)
    np.testing.assert_array_equal(phys_t.numpy(), np.asarray(phys_j))
    node = rng.integers(0, n_prev, n).astype(np.int32)
    node[::9] = -1
    feat = np.array([1, 5], np.int32)[:n_prev]
    thr = np.array([1, 0], np.int32)[:n_prev]
    g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
    h = rng.choice([0.5, 1.0], n).astype(np.float32)
    safe = np.maximum(node, 0)
    hist_j, nn_j = jh.fused_descend_histogram(
        phys_j, jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), n_prev, B,
        "segment", fuse=True, layout=lj)
    left, nn = th.fused_descend_histogram(
        phys_t, _t(node), _t(feat), _t(thr), _t(g), _t(h), n_prev, B,
        fuse=True, layout=lt, by_node=True)
    np.testing.assert_array_equal(nn.numpy(), np.asarray(nn_j))
    assert left.shape == (2, n_prev, lt.storage_features, lt.sync_bins)
    np.testing.assert_array_equal(left.numpy().view(np.uint32),
                                  np.asarray(hist_j).view(np.uint32))


def test_sync_sees_the_int64_sums_and_children_match_fused_round():
    n, F, n_prev = 1000, 4, 4
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=21,
                                           exact=False)
    scales = th.hist_scales(_t(g), _t(h))
    seen = []

    def double(acc):
        seen.append(acc.dtype)
        return acc * 2

    left, nn = th.fused_descend_histogram(
        _t(bins_t), _t(node), _t(feat), _t(thr), _t(g), _t(h), n_prev, B,
        fuse=True, by_node=True, scales=scales)
    left2, _ = th.fused_descend_histogram(
        _t(bins_t), _t(node), _t(feat), _t(thr), _t(g), _t(h), n_prev, B,
        fuse=True, by_node=True, scales=scales, sync=double)
    assert seen == [torch.int64]
    # x2 in fixed point is x2 exactly after the conversion
    assert torch.equal(left2, 2 * left)
    # left children + the subtraction = the fused round, bit for bit
    prev = th.build_histogram(_t(bins_t), _t(node), _t(g), _t(h), n_prev, B,
                              scales=scales)
    nn_r, hist_r, _ = th.fused_round(_t(bins_t), _t(node), _t(feat),
                                     _t(thr), _t(g), _t(h), prev, n_prev, B,
                                     by_node=True, scales=scales)
    assert torch.equal(nn, nn_r)
    assert torch.equal(th.sibling_pairs(left, prev), hist_r)


def test_kernel_wrapper_refuses_cpu_tensors():
    n, F = 64, 3
    bins = torch.zeros(F, n, dtype=torch.uint8)
    node = torch.zeros(n, dtype=torch.int32)
    g = torch.ones(n)
    from dmlc_core_tpu_torch.base.logging import Error

    with pytest.raises(Error, match="CUDA"):
        th.fused_descend_kernel(bins, node, node[:1], node[:1], g, g, 1, B,
                                0, 0, True)
    assert th.fused_descend_kernel.launches == 0
