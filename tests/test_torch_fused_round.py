"""Port parity of the fused-round kernel's plain version
(``fused_round_plain`` behind ``fused_round`` on CPU tensors) against the
JAX ``fused_round`` (Pallas, interpret mode off-TPU).

``new_node`` is integer work: bit-equal.  Histograms are bit-equal on
bf16-exact g/h (every sum, and ``prev − left``, is exact in both), and
allclose (rtol 1e-5, atol 1e-5) on general g/h, where the f32 running
sums of the JAX kernel and the port's fixed-point sums round differently.
The TPU kernel rounds g/h to bf16 before its one-hot dot, so the general
inputs are bf16-representable values with inexact sums: both sides then
sum the same numbers.
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

B = 32


def _level(n, F, n_prev, seed, exact):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, B, (F, n)).astype(np.uint8)
    node = rng.integers(0, n_prev, n).astype(np.int32)
    node[rng.random(n) < 0.05] = -1
    feat = rng.integers(0, F, n_prev).astype(np.int32)
    thr = rng.integers(0, B, n_prev).astype(np.int32)
    if exact:
        g = rng.choice([-1.0, -0.5, 0.5, 1.0], n).astype(np.float32)
        h = rng.choice([0.5, 1.0], n).astype(np.float32)
    else:
        g = _bf16(rng.normal(size=n))
        h = _bf16(rng.random(n))
    return bins_t, node, feat, thr, g, h


def _bf16(x):
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _jax_round(bins_t, node, feat, thr, g, h, n_prev):
    safe = np.maximum(node, 0)
    prev = jh.build_histogram(jnp.asarray(bins_t), jnp.asarray(node),
                              jnp.asarray(g), jnp.asarray(h), n_prev, B,
                              "pallas", transposed=True)
    new_node, hist, scores = jh.fused_round(
        jnp.asarray(bins_t), jnp.asarray(node), jnp.asarray(feat[safe]),
        jnp.asarray(thr[safe]), jnp.asarray(g), jnp.asarray(h), prev,
        n_prev, B, score_fn=lambda x: x.sum())
    return np.asarray(prev), np.asarray(new_node), np.asarray(hist), scores


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_prev", [1, 2, 4])
@pytest.mark.parametrize("exact", [True, False])
def test_matches_jax_fused_round(n_prev, exact):
    n, F = 1203, 5
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=n_prev,
                                           exact=exact)
    prev, nn_j, hist_j, score_j = _jax_round(bins_t, node, feat, thr, g, h,
                                             n_prev)
    calls = []

    def score_fn(hs):
        calls.append(hs.shape)
        return hs.sum()

    # the training loop's form: per-node split tables
    nn_t, hist_t, score_t = th.fused_round(
        _t(bins_t), _t(node), _t(feat), _t(thr), _t(g), _t(h), _t(prev),
        n_prev, B, score_fn=score_fn, by_node=True)
    np.testing.assert_array_equal(nn_t.numpy(), nn_j)
    assert hist_t.shape == (2, 2 * n_prev, F, B)
    if exact:
        np.testing.assert_array_equal(hist_t.numpy().view(np.uint32),
                                      hist_j.view(np.uint32))
    else:
        np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-5,
                                   atol=1e-5)
    # score_fn ran once, on the emitted histograms
    assert calls == [(2, 2 * n_prev, F, B)]
    assert float(score_t) == float(hist_t.sum())
    np.testing.assert_allclose(float(score_t), float(score_j), rtol=1e-4)


def test_per_row_and_per_node_forms_agree():
    n, F, n_prev = 999, 4, 4
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=11,
                                           exact=False)
    safe = np.maximum(node, 0)
    prev = th.build_histogram(_t(bins_t), _t(node), _t(g), _t(h), n_prev, B)
    a = th.fused_round(_t(bins_t), _t(node), _t(feat), _t(thr), _t(g), _t(h),
                       prev, n_prev, B, by_node=True)
    b = th.fused_round(_t(bins_t), _t(node), _t(feat[safe]), _t(thr[safe]),
                       _t(g), _t(h), prev, n_prev, B)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2] is None


def test_children_sum_to_parent():
    # left + right = prev, and the left child is the histogram of the
    # rows with an even new node id
    n, F, n_prev = 1500, 3, 2
    bins_t, node, feat, thr, g, h = _level(n, F, n_prev, seed=5, exact=True)
    scales = th.hist_scales(_t(g), _t(h))
    prev = th.build_histogram(_t(bins_t), _t(node), _t(g), _t(h), n_prev, B,
                              scales=scales)
    new_node, hist, _ = th.fused_round(
        _t(bins_t), _t(node), _t(feat), _t(thr), _t(g), _t(h), prev, n_prev,
        B, by_node=True, scales=scales)
    pair = hist.reshape(2, n_prev, 2, F, B)
    assert torch.equal(pair[:, :, 0] + pair[:, :, 1], prev)
    both = th.build_histogram(_t(bins_t), new_node, _t(g), _t(h),
                              2 * n_prev, B, scales=scales)
    assert torch.equal(both[:, 0::2], hist[:, 0::2])
