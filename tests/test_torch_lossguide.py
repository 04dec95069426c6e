"""Loss-guide growth and the bin levers in the port's ``HistGBT``
(``DMLC_GROW_POLICY=lossguide``, ``DMLC_MAX_LEAVES``, ``DMLC_BIN_PACK``,
``DMLC_FEATURE_BUNDLE``), against the JAX package's ``HistGBT`` under the
same environment, and the oracle contracts of tests/test_lossguide.py and
tests/test_binpack.py held on the port itself.

Tolerances, and why: split structure (``feat``/``thr``) is held EXACTLY in
every tree; leaves and predictions at atol 1e-5 — the JAX CPU path sums
f32 gradients in a running order, the port in fixed point, and a small
leaf's sum cancels (as in tests/test_torch_histgbt.py).  Within the port,
pack on/off gives byte-identical model files: the compact remap and the
nibbles only relabel histogram cells, and fixed-point sums do not depend
on order.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.ops import histogram as jh  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import histgbt as port_histgbt  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=4, max_depth=4, n_bins=32, objective="binary:logistic",
          learning_rate=0.3)
LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_FEATURE_BUNDLE")
LG = {"DMLC_GROW_POLICY": "lossguide"}

#: the environments held against the JAX package
ENVS = {
    "lossguide": LG,
    "lossguide_6_leaves": {**LG, "DMLC_MAX_LEAVES": "6"},
    "lossguide_pack": {**LG, "DMLC_BIN_PACK": "1"},
    "lossguide_bundle": {**LG, "DMLC_FEATURE_BUNDLE": "1"},
    "bench_levers": {**LG, "DMLC_MAX_LEAVES": "8", "DMLC_BIN_PACK": "1",
                     "DMLC_FEATURE_BUNDLE": "1"},
}


def _xy(n=2003, seed=0):
    """Gaussian features, a 3-valued feature (4) and a one-hot block of
    three exclusive features (5-7): both levers fire."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    X[:, 4] = rng.integers(0, 3, n)
    cat = rng.integers(0, 4, n)
    X[:, 5:8] = (cat[:, None] == np.arange(1, 4)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 4] - X[:, 1] * X[:, 3] + 0.8 * X[:, 5]
          - 0.6 * X[:, 7]) > 0).astype(np.float32)
    return X, y


def _set_env(monkeypatch, env):
    for k in LEVERS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _port_fit(monkeypatch, env, X, y, **kw):
    _set_env(monkeypatch, env)
    return HistGBT(device="cpu", **{**KW, **kw}).fit(X, y)


@pytest.fixture(scope="module")
def data():
    return _xy()


@pytest.fixture(scope="module")
def fits(data):
    """{env name: (JAX model, port model)} on the same data and env."""
    X, y = data
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, env in ENVS.items():
            _set_env(mp, env)
            jm = JaxHistGBT(mesh=local_mesh(1), **KW).fit(X, y)
            tm = HistGBT(device="cpu", **KW).fit(X, y)
            out[name] = (jm, tm)
    finally:
        mp.undo()
    return out


def _same_structure(a_trees, b_trees):
    assert len(a_trees) == len(b_trees)
    for i, (a, b) in enumerate(zip(a_trees, b_trees)):
        np.testing.assert_array_equal(b["feat"], a["feat"], err_msg=str(i))
        np.testing.assert_array_equal(b["thr"], a["thr"], err_msg=str(i))


@pytest.mark.parametrize("name", sorted(ENVS))
def test_matches_jax_lossguide(name, fits, data):
    X, _ = data
    jm, tm = fits[name]
    assert (tm._bin_layout is None) == (jm._bin_layout is None)
    if tm._bin_layout is not None:
        assert tuple(tm._bin_layout) == tuple(jm._bin_layout)
    _same_structure(jm.trees, tm.trees)
    for a, b in zip(jm.trees, tm.trees):
        np.testing.assert_allclose(b["leaf"], a["leaf"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(b["gain"], a["gain"], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), atol=1e-5)


def test_levers_fire_on_this_data(fits):
    assert fits["lossguide"][1]._bin_layout is None
    pack = fits["lossguide_pack"][1]._bin_layout
    assert pack is not None and len(pack.pairs) == 2 and not pack.has_bundles
    bundle = fits["lossguide_bundle"][1]._bin_layout
    assert bundle is not None and bundle.has_bundles and not bundle.pairs
    both = fits["bench_levers"][1]._bin_layout
    assert both is not None and both.has_bundles and both.pairs


def test_model_files_cross_load_with_levers(fits, data, tmp_path):
    X, _ = data
    jm, tm = fits["bench_levers"]
    tm.save_model(str(tmp_path / "port.model"))
    jm.save_model(str(tmp_path / "jax.model"))
    in_jax = JaxHistGBT.load_model(str(tmp_path / "port.model"),
                                   mesh=local_mesh(1))
    in_port = HistGBT.load_model(str(tmp_path / "jax.model"), device="cpu")
    np.testing.assert_array_equal(in_jax.predict(X, output_margin=True),
                                  tm.predict(X, output_margin=True))
    np.testing.assert_array_equal(in_port.predict(X, output_margin=True),
                                  jm.predict(X, output_margin=True))


def test_unlimited_budget_matches_depthwise(monkeypatch, data):
    X, y = data
    m0 = _port_fit(monkeypatch, {}, X, y)
    m1 = _port_fit(monkeypatch, LG, X, y)
    _same_structure(m0.trees, m1.trees)
    for a, b in zip(m0.trees, m1.trees):
        np.testing.assert_allclose(a["gain"], b["gain"], rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(m0.predict(X), m1.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_max_leaves_budget_respected(monkeypatch, data):
    X, y = data
    m = _port_fit(monkeypatch, {**LG, "DMLC_MAX_LEAVES": "6"}, X, y)
    for t in m.trees:
        assert int((np.asarray(t["gain"]) > 0).sum()) <= 5
        assert int((np.asarray(t["leaf"]) != 0).sum()) <= 6
    assert ((m.predict(X) > 0.5) == y).mean() > 0.8


def test_packed_lossguide_structure_and_pack_byte_parity(monkeypatch, data,
                                                         tmp_path):
    X, y = data
    depthwise = _port_fit(monkeypatch, {}, X, y)
    lg = _port_fit(monkeypatch, LG, X, y)
    packed = _port_fit(monkeypatch, {**LG, "DMLC_BIN_PACK": "1"}, X, y)
    assert packed._bin_layout is not None
    _same_structure(depthwise.trees, packed.trees)
    lg.save_model(str(tmp_path / "a"))
    packed.save_model(str(tmp_path / "b"))
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_bundled_depthwise_same_structure(monkeypatch, data):
    X, y = data
    m0 = _port_fit(monkeypatch, {}, X, y)
    m1 = _port_fit(monkeypatch, {"DMLC_FEATURE_BUNDLE": "1"}, X, y)
    assert m1._bin_layout is not None and m1._bin_layout.has_bundles
    _same_structure(m0.trees, m1.trees)
    np.testing.assert_allclose(m0.predict(X), m1.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_invalid_policy_and_budgets_rejected(monkeypatch, data):
    X, y = data
    X, y = X[:203], y[:203]
    for env in ({"DMLC_GROW_POLICY": "bogus"},
                {**LG, "DMLC_MAX_LEAVES": "1"},
                {**LG, "DMLC_MAX_LEAVES": "-2"},
                {**LG, "DMLC_MAX_LEAVES": "many"}):
        with pytest.raises(Error):
            _port_fit(monkeypatch, env, X, y)
    # the histogram pool (leaves x 2 x F x B f32) is capped at 256 MB
    _set_env(monkeypatch, LG)
    model = HistGBT(device="cpu", max_depth=12, n_bins=256)
    with pytest.raises(Error, match="256 MB"):
        model._lossguide_leaves(8000)


def test_expansions_make_no_host_sync(monkeypatch, data):
    """After the tree's one scale sync, the expansion loop converts no
    tensor to a Python value: no ``.item()``, ``.tolist()``, ``bool()``,
    ``int()``, ``float()`` or ``.numpy()``."""
    X, y = data
    armed = []

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *a, **k):
            if armed:
                raise AssertionError(f"host sync: Tensor.{name}")
            return orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapper)

    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__", "numpy"):
        guard(name)
    scales = port_histgbt.hist_scales
    grow = HistGBT._grow_tree_lossguide

    def armed_scales(g, h):
        out = scales(g, h)
        armed.append(True)
        return out

    def disarm_after(self, *a, **k):
        try:
            return grow(self, *a, **k)
        finally:
            armed.clear()

    monkeypatch.setattr(port_histgbt, "hist_scales", armed_scales)
    monkeypatch.setattr(HistGBT, "_grow_tree_lossguide", disarm_after)
    m = _port_fit(monkeypatch, ENVS["bench_levers"], X, y, n_trees=2)
    assert len(m.trees) == 2


def test_lossguide_accounting_matches_jax():
    for depth in (1, 4, 6):
        for leaves in (0, 6, 16):
            assert th.leaves_built_per_round(depth, "lossguide", leaves) == \
                jh.leaves_built_per_round(depth, "lossguide", leaves)
            for fused in (False, True):
                kw = dict(grow_policy="lossguide", max_leaves=leaves,
                          fused=fused)
                assert th.bins_bytes_per_round(depth, 581_012, 12, **kw) \
                    == jh.bins_bytes_per_round(depth, 581_012, 12, **kw)
