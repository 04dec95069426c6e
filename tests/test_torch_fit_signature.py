"""``HistGBT.fit``'s signature is the JAX package's (ROADMAP C7).

JAX: ``fit(X, y, weight=None, eval_every=0, warmup_rounds=0, cuts=None,
eval_set=None, early_stopping_rounds=0, qid=None)``.  Before the repair
the port's ``fit(X, y, warmup_rounds=1)`` raised ``TypeError`` and
``fit(X, y, None, 1)`` bound ``cuts=1``.
"""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402

torch.set_num_threads(2)

KW = dict(n_trees=3, max_depth=3, n_bins=16)


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_TPU_ROUNDS_PER_DISPATCH",
              "DMLC_BIN_PACK", "DMLC_FEATURE_BUNDLE"):
        monkeypatch.delenv(k, raising=False)


def _xy(n=600, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)


def _bytes(model, tmp_path, name):
    path = str(tmp_path / name)
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


def test_parameters_are_jax_order():
    def names(fn):
        return [(p.name, p.default, p.kind)
                for p in inspect.signature(fn).parameters.values()]

    assert names(HistGBT.fit) == names(JaxHistGBT.fit)


def test_warmup_rounds_keyword_trains_and_discards(tmp_path):
    X, y = _xy()
    plain = HistGBT(device="cpu", **KW).fit(X, y)
    warm = HistGBT(device="cpu", **KW).fit(X, y, warmup_rounds=1)
    assert len(warm.trees) == KW["n_trees"]
    assert warm.last_warm_dispatch_seconds is not None
    assert _bytes(warm, tmp_path, "w") == _bytes(plain, tmp_path, "p")
    jm = JaxHistGBT(mesh=local_mesh(1), **KW).fit(X, y, warmup_rounds=1)
    assert len(jm.trees) == KW["n_trees"]


def test_fourth_positional_is_eval_every(tmp_path):
    X, y = _xy()
    plain = HistGBT(device="cpu", **KW).fit(X, y)
    m = HistGBT(device="cpu", **KW).fit(X, y, None, 1)
    assert _bytes(m, tmp_path, "e") == _bytes(plain, tmp_path, "p")
    JaxHistGBT(mesh=local_mesh(1), **KW).fit(X, y, None, 1)


def test_sixth_positional_is_cuts():
    X, y = _xy()
    ref = HistGBT(device="cpu", **KW).fit(X, y)
    cuts = ref.cuts.numpy() + np.float32(0.25)
    m = HistGBT(device="cpu", **KW).fit(X, y, None, 0, 0, cuts)
    np.testing.assert_array_equal(m.cuts.numpy(), cuts)


def test_qid_refusals_have_jax_messages():
    X, y = _xy(40)
    with pytest.raises(Error, match="needs qid"):
        HistGBT(device="cpu", objective="rank:pairwise").fit(X, y)
    with pytest.raises(JaxError, match="needs qid"):
        JaxHistGBT(objective="rank:pairwise").fit(X, y)
    with pytest.raises(Error, match="only valid for rank"):
        HistGBT(device="cpu").fit(X, y, qid=np.zeros(40, np.int64))
    with pytest.raises(JaxError, match="only valid for rank"):
        JaxHistGBT().fit(X, y, qid=np.zeros(40, np.int64))
