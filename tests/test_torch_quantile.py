"""Port parity: quantile cuts and binning are BIT-EQUAL to the JAX
package's (``compute_cuts`` / ``apply_bins``), including the XLA addition
order of ``jnp.cumsum`` and an atom-dominated column that exercises the
strictly-increasing guard.  Compared as raw bits: the tolerance is 0."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.ops import quantile as jq  # noqa: E402
from dmlc_core_tpu_torch.ops import quantile as tq  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.uint32)


def _matrix(n, F, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    # atom-dominated: 70% exact zeros (a densified sparse column) — runs
    # of equal quantile targets that the guard must fan out
    X[:, 0] = np.where(rng.random(n) < 0.7, 0.0, X[:, 0])
    X[:, 1] = rng.integers(0, 3, n)              # 3-valued column
    X[:, 2] = np.exp(3.0 * X[:, 2])              # heavy tail
    return X


@pytest.mark.parametrize("length", [1, 5, 16, 17, 33, 255, 256, 2048, 5000])
def test_xla_cumsum_matches_jnp_cumsum(length):
    rng = np.random.default_rng(length)
    x = (rng.standard_normal((3, length))
         * np.exp(3 * rng.standard_normal((3, length)))).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    got = tq.xla_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want0 = np.asarray(jnp.cumsum(jnp.asarray(x.T), axis=0))
    got0 = tq.xla_cumsum(torch.from_numpy(np.ascontiguousarray(x.T)),
                         dim=0).numpy()
    np.testing.assert_array_equal(_bits(got0), _bits(want0))


@pytest.mark.parametrize("num", [2, 33, 257, 2048])
def test_linspace_grid_matches_jax(num):
    np.testing.assert_array_equal(
        _bits(tq._linspace01(num, "cpu").numpy()),
        _bits(jnp.linspace(0.0, 1.0, num)))


@pytest.mark.parametrize("n_bins", [32, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuts_and_bins_bit_equal(n_bins, weighted):
    n, F = 1503, 4
    X = _matrix(n, F, seed=n_bins + weighted)
    w = None
    if weighted:
        w = (np.random.default_rng(5).random(n) + 0.1).astype(np.float32)
    want = np.array(jq.compute_cuts(X, n_bins, weight=w))
    got = tq.compute_cuts(torch.from_numpy(X), n_bins,
                          weight=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (F, n_bins - 1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the guard made every feature's cuts strictly increasing
    assert np.all(np.diff(got.numpy(), axis=1) > 0)
    bins_j = np.asarray(jq.apply_bins(jnp.asarray(X), jnp.asarray(want)))
    bins_t = tq.apply_bins(torch.from_numpy(X), torch.from_numpy(want))
    assert bins_t.dtype == torch.uint8 and bins_t.shape == (F, n)
    np.testing.assert_array_equal(bins_t.numpy(), bins_j.T)


def test_summary_stages_bit_equal():
    X = _matrix(777, 3, seed=1)
    s_j = np.asarray(jq.local_summary(jnp.asarray(X), None, 256))
    s_t = tq.local_summary(torch.from_numpy(X), None, 256).numpy()
    np.testing.assert_array_equal(_bits(s_t), _bits(s_j))
    m_j = np.asarray(jq.merge_summaries(jnp.asarray(s_j)[None], 64))
    m_t = tq.merge_summaries(torch.from_numpy(s_t)[None], 64).numpy()
    np.testing.assert_array_equal(_bits(m_t), _bits(m_j))
