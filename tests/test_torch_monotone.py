"""Monotone constraints in the port against the JAX package, on the CPU.

* the split chooser with ``mono`` and per-node ``bounds`` (and a
  ``feat_mask``) picks JAX's ``(feat, thr)`` with gains within rtol 1e-5
  / atol 1e-6 and equal child sums, on order-exact histograms (cells
  that are multiples of 0.5: every cumulative sum exact in both);
* constrained fits meet parity level (b) (tests/_torch_parity.py) with
  +1 and −1 constraints, and their leaf bounds hold: the margin along a
  sweep of each constrained feature is monotone for every probe row, in
  both packages alike;
* NaN, ``reg_alpha``, lossguide and malformed constraint lists are
  refused with JAX's messages.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import assert_level_b  # noqa: E402
from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models.gbt_split import (  # noqa: E402
    _make_best_split as jax_best_split)
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_split import (  # noqa: E402
    _make_best_split)

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=4, max_depth=4, n_bins=32)
LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND",
          "DMLC_FUSED_ROUND", "DMLC_TPU_BIN_BACKEND")


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)


def _exact_hist(seed, N=4, F=5, B=16):
    rng = np.random.default_rng(seed)
    g = rng.integers(-6, 7, size=(N, F, B)).astype(np.float32) * 0.5
    h = rng.integers(0, 5, size=(N, F, B)).astype(np.float32) * 0.5
    # every feature of a node shares its totals, as a real histogram
    g[:, :, -1] += g[:, :1].sum(-1) - g.sum(-1)
    h[:, :, -1] += h[:, :1].sum(-1) - h.sum(-1)
    h[:, :, -1] = np.abs(h[:, :, -1])
    return np.stack([g, h])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_sums", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monotone_split_matches_jax(seed, with_sums, masked):
    B = 16
    hist = _exact_hist(seed, B=B)
    mono = np.array([1, -1, 0, 1, -1], np.int32)
    rng = np.random.default_rng(seed + 10)
    lo = rng.uniform(-1.0, 0.0, 4).astype(np.float32)
    bounds = np.stack([lo, lo + rng.uniform(0.1, 1.5, 4).astype(np.float32)],
                      1)
    bounds[0] = (-np.inf, np.inf)
    fm = np.array([True, True, False, True, True]) if masked else None
    want = jax_best_split(B, 1.0, 0.0, 0.5, with_child_sums=with_sums,
                          mono=mono)(jnp.asarray(hist),
                                     None if fm is None else jnp.asarray(fm),
                                     jnp.asarray(bounds))
    got = _make_best_split(B, 1.0, 0.0, 0.5, with_child_sums=with_sums,
                           mono=mono)(torch.from_numpy(hist),
                                      None if fm is None
                                      else torch.from_numpy(fm),
                                      torch.from_numpy(bounds))
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if masked:
        assert not (got[0].numpy()[got[1].numpy() < B - 1] == 2).any()


def _data(n=1500, F=6, seed=4):
    """HIGGS-like rows: + 0.5·x2, − 0.8·x3·(x4 > 0) in the label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + 0.5 * X[:, 2]
          - 0.8 * X[:, 3] * (X[:, 4] > 0)) > 0).astype(np.float32)
    return X, y


def _sweep_is_monotone(model, X, f, sign):
    """Margins of each probe row with feature ``f`` swept over 64 values
    move with ``sign`` (never against it)."""
    grid = np.linspace(-3, 3, 64, dtype=np.float32)
    probes = np.repeat(X, len(grid), axis=0)
    probes[:, f] = np.tile(grid, len(X))
    m = np.asarray(model.predict(probes, output_margin=True)
                   ).reshape(len(X), len(grid))
    step = np.diff(m, axis=1) * sign
    return bool((step >= 0).all())


@pytest.mark.parametrize("mono", [[0, 0, 1, -1, 0, 0], [1, -1, 1, 0, 0, 0]])
def test_constrained_fit_meets_level_b_and_is_monotone(mono):
    X, y = _data()
    kw = dict(KW, monotone_constraints=mono)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    Xv, _ = _data(1500, seed=9)
    assert_level_b(jm, tm, Xv, X=X)
    for f, sign in enumerate(mono):
        if sign:
            assert _sweep_is_monotone(tm, Xv[:100], f, sign), f
            assert _sweep_is_monotone(jm, Xv[:100], f, sign), f
    # the constraint binds: unconstrained, the same fit is not monotone
    free = HistGBT(device="cpu", **KW).fit(X, y)
    assert not all(_sweep_is_monotone(free, Xv[:100], f, s)
                   for f, s in enumerate(mono) if s)


def test_leaves_stay_in_their_bounds():
    # the leaf clip: every tree, alone, is monotone in the constrained
    # features (bounds bind each tree's own weights)
    X, y = _data()
    mono = [0, 0, 1, -1, 0, 0]
    tm = HistGBT(device="cpu", **dict(KW, monotone_constraints=mono))
    tm.fit(X, y)
    for t in range(len(tm.trees)):
        assert _sweep_is_monotone(_one_tree(tm, t), X[:60], 2, 1), t
        assert _sweep_is_monotone(_one_tree(tm, t), X[:60], 3, -1), t


def _one_tree(model, t):
    m = HistGBT.from_state(dict(model.to_state(),
                                trees=[model.trees[t]]), device="cpu")
    return m


def test_monotone_refusals_mirror_jax(monkeypatch):
    X, y = _data(400)
    Xn = X.copy()
    Xn[::7, 1] = np.nan

    def both(msg, fn):
        with pytest.raises(JaxError, match=msg):
            fn(lambda **k: JaxHistGBT(mesh=local_mesh(1), **k))
        with pytest.raises(Error, match=msg):
            fn(lambda **k: HistGBT(device="cpu", **k))

    mono = [1, 0, 0, 0, 0, 0]
    both("monotone_constraints with NaN features is not supported",
         lambda make: make(**KW, monotone_constraints=mono).fit(Xn, y))
    both("monotone_constraints with reg_alpha is not supported",
         lambda make: make(**KW, monotone_constraints=mono,
                           reg_alpha=0.5).fit(X, y))
    both("monotone_constraints length must equal n_features",
         lambda make: make(**KW, monotone_constraints=[1, 0]).fit(X, y))
    both("monotone_constraints values must be -1, 0 or \\+1",
         lambda make: make(**KW, monotone_constraints=[2, 0, 0, 0, 0, 0])
         .fit(X, y))
    monkeypatch.setenv("DMLC_GROW_POLICY", "lossguide")
    both("DMLC_GROW_POLICY=lossguide with monotone_constraints",
         lambda make: make(**KW, monotone_constraints=mono).fit(X, y))
    # all-zero constraints are no constraint, in lossguide too
    both_ok = [HistGBT(device="cpu", **KW, monotone_constraints=[0] * 6)
               .fit(X, y), JaxHistGBT(mesh=local_mesh(1), **KW,
                                      monotone_constraints=[0] * 6).fit(X, y)]
    assert all(len(m.trees) == KW["n_trees"] for m in both_ok)
