"""Row and column sampling in the port, held to the JAX package's draws.

* ``utils.prng`` against ``jax.random`` (threefry2x32, partitionable, the
  installed defaults), bit for bit: ``key`` for seeds 0, 1, 7, 2^31−1 and
  2^32+5, ``split``, ``fold_in`` of 0..40 and ``uniform`` of shapes (1,),
  (1000,), (3, 5) and (100_003,); element i's draw depends on i alone,
  so a shorter shape draws a prefix (a padded shard's real rows);
* each round's keep and feature masks, captured from the fit, against
  the masks JAX's program derives (``fold_in(key(seed), global round)``
  per chunk, ``split`` per round, the row key folded with the shard),
  for chunks of 25 and of 2 rounds;
* sampled fits meet parity level (b) (tests/_torch_parity.py) — plain,
  NaN, multiclass, and a row count that JAX pads (``DMLC_HIST_BLOCKS=8``
  pads 1003 rows to 1008 on one device; the port draws 1003) — over
  every tree, past a tie that parts them from the port's trees up to it,
  loaded into both packages;
* the same rounds chunked differently draw differently, in both packages
  alike;
* ``subsample`` / ``colsample_bytree`` of 0 are refused with JAX's
  messages.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import (  # noqa: E402
    assert_level_b, assert_level_b_through)
from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.utils import prng  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

SEEDS = (0, 1, 7, 2 ** 31 - 1, 2 ** 32 + 5)
SHAPES = ((1,), (1000,), (3, 5), (100_003,))
KW = dict(n_trees=4, max_depth=4, n_bins=32, subsample=0.8,
          colsample_bytree=0.7, seed=3)
LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND",
          "DMLC_FUSED_ROUND", "DMLC_TPU_BIN_BACKEND",
          "DMLC_TPU_ROUNDS_PER_DISPATCH")


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)


def _words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_jaxs(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    np.testing.assert_array_equal(prng.split(tk).numpy(),
                                  _words(jax.random.split(jk)))
    np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                  _words(jax.random.split(jk, 5)))
    for d in range(41):
        np.testing.assert_array_equal(
            prng.fold_in(tk, d).numpy(), _words(jax.random.fold_in(jk, d)),
            err_msg=str(d))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_is_jaxs_bit_for_bit(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 11)
    tk = prng.fold_in(prng.key(seed), 11)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(tk, shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert got.tobytes() == want.tobytes()
    assert 0.0 <= got.min() and got.max() < 1.0
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))


def test_a_shorter_row_shape_draws_the_padded_shapes_prefix():
    jk = jax.random.key(5)
    padded = np.asarray(jax.random.uniform(jk, (1008,)))
    got = prng.uniform(prng.key(5), (1003,)).numpy()
    assert got.tobytes() == padded[:1003].tobytes()


def _jax_masks(seed, n_rows, n_features, rounds, chunk, subsample,
               colsample, n_prior=0):
    """The masks of JAX's round program (models/histgbt.py: the chunk key
    ``fold_in(key(seed), n_prior + done)``, ``split`` per round, then
    ``sample_masks`` on shard 0), from ``jax.random``."""
    base = jax.random.key(seed)
    out, done = [], 0
    while done < rounds:
        k = min(chunk, rounds - done)
        key_c = jax.random.fold_in(base, n_prior + done)
        for _ in range(k):
            key_c, key_r = jax.random.split(key_c)
            key_rows, key_cols = jax.random.split(key_r)
            keep = feat = None
            if subsample < 1.0:
                keep = np.asarray(jax.random.uniform(
                    jax.random.fold_in(key_rows, 0), (n_rows,)) < subsample)
            if colsample < 1.0:
                n_keep = max(1, int(np.ceil(colsample * n_features)))
                scores = jax.random.uniform(key_cols, (n_features,))
                feat = np.asarray(scores <= jnp.sort(scores)[n_keep - 1])
            out.append((keep, feat))
        done += k
    return out


def _data(n=1500, F=6, seed=4, nan=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + 0.5 * X[:, 2]
          - 0.8 * X[:, 3] * (X[:, 4] > 0)) > 0).astype(np.float32)
    if nan:
        X[:, 1:][rng.random((n, F - 1)) < 0.1] = np.nan
        X[X[:, 0] > 1.0, 0] = np.nan
    return X, y


@pytest.mark.parametrize("chunk", [25, 2])
@pytest.mark.parametrize("rates", [(0.8, 0.7), (0.5, 1.0), (1.0, 0.34)])
def test_each_rounds_masks_are_jaxs(chunk, rates, monkeypatch):
    monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", str(chunk))
    sub, col = rates
    X, y = _data(700)
    seen = []
    real = HistGBT._sample_masks

    def spy(self, key, n, n_features):
        keep, feat = real(self, key, n, n_features)
        seen.append((None if keep is None else keep.numpy(),
                     None if feat is None else feat.numpy()))
        return keep, feat

    monkeypatch.setattr(HistGBT, "_sample_masks", spy)
    m = HistGBT(device="cpu", **dict(KW, subsample=sub,
                                     colsample_bytree=col, n_trees=5))
    m.fit(X, y)
    m.param.n_trees = 3
    m.fit(X, y)                               # continued: rounds 5..7
    want = (_jax_masks(3, len(X), 6, 5, chunk, sub, col)
            + _jax_masks(3, len(X), 6, 3, chunk, sub, col, n_prior=5))
    assert len(seen) == len(want) == 8
    for r, ((k, f), (wk, wf)) in enumerate(zip(seen, want)):
        for a, b in ((k, wk), (f, wf)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == np.bool_
                np.testing.assert_array_equal(a, b, err_msg=str(r))
        if f is not None:
            assert f.sum() == max(1, math.ceil(col * 6))


@pytest.mark.parametrize("case", ["plain", "nan", "softmax", "padded"])
def test_sampled_fits_meet_level_b(case, monkeypatch):
    kw = dict(KW)
    X, y = _data(1003 if case == "padded" else 1500, nan=case == "nan")
    if case == "softmax":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]
                        ).astype(np.float32)
        kw.update(objective="multi:softmax", num_class=3)
    if case == "padded":
        # JAX pads the rows to a multiple of the 8 blocks: 1008
        monkeypatch.setenv("DMLC_HIST_BLOCKS", "8")
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
    tm = HistGBT(device="cpu", **kw).fit(X, y)
    Xv, _ = _data(1500, seed=8, nan=case == "nan")
    # where the fits part at a tie (ROADMAP C4: under row sampling a bin
    # holding only unsampled rows, g = h = 0, at a node ties two
    # thresholds exactly while sending those rows apart), both packages
    # continue from the port's trees up to it and are held on
    stages = assert_level_b_through(jm, tm, X, y, Xv)
    assert stages[-1][2] is None


def test_chunking_moves_the_draws_in_both_packages(monkeypatch):
    X, y = _data()
    kw = dict(KW, n_trees=4)
    fits = {}
    for chunk in ("25", "1"):
        monkeypatch.setenv("DMLC_TPU_ROUNDS_PER_DISPATCH", chunk)
        jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y)
        tm = HistGBT(device="cpu", **kw).fit(X, y)
        assert assert_level_b(jm, tm, X[:500], X=X)[1] is None
        fits[chunk] = tm
    # round 0 draws fold_in(key, 0)'s first split under both chunkings;
    # round 1 draws from another key
    a, b = fits["25"].trees, fits["1"].trees
    assert all(np.array_equal(a[0][k], b[0][k]) for k in a[0])
    assert not all(np.array_equal(a[1][k], b[1][k]) for k in a[1])


def test_zero_rates_are_refused_like_jax():
    for field, msg in (("subsample", "subsample must be in \\(0, 1\\]"),
                       ("colsample_bytree",
                        "colsample_bytree must be in \\(0, 1\\]")):
        with pytest.raises(JaxError, match=msg):
            JaxHistGBT(mesh=local_mesh(1), **{field: 0.0})
        with pytest.raises(Error, match=msg):
            HistGBT(device="cpu", **{field: 0.0})
