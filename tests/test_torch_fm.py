"""``FM`` (``models/fm.py``) in the port, against the JAX package, on the
CPU.

Tolerances: the initial ``v`` bit-equal to JAX's (the same numpy draws);
parameters after a few epochs from the same initial state within rtol
1e-3, atol 1e-4 of JAX's — the JAX package's own bound between two
summation orders (``tests/test_fm.py``, 8 devices against 1); the
margin identity within rtol 2e-4, atol 1e-4 of a pairwise loop; model
files cross-load both ways (Adam's state included, so a loaded model
resumes the same trajectory); 2 gloo ranks against 1 process within the
same tolerance.

``tests/test_fm.py`` is loaded against the port as well (``*_port``),
with ``jnp.asarray`` standing for ``torch.as_tensor``.  Left out:
``test_mesh_matches_single_device`` (a JAX mesh of 8 CPU devices; the
port's data axis is processes, held here by
``test_two_ranks_match_one_process``).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.models.checkpoint import gather_tree  # noqa: E402
from dmlc_core_tpu.models.fm import FM as JaxFM  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data.iter import ArrayRowIter  # noqa: E402
from dmlc_core_tpu_torch.models.fm import FM  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import launch  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 1e-4

_SUITE = load_port("test_fm.py", [
    ("import jax\nimport jax.numpy as jnp\nfrom jax.sharding import Mesh\n",
     "import torch\nfrom types import SimpleNamespace\n"
     "jnp = SimpleNamespace(float32=torch.float32, asarray=lambda a, "
     "dtype=None: torch.as_tensor(np.asarray(a), dtype=dtype))\n")])
export(globals(), _SUITE, ["TestFMMargin", "TestFMTraining"],
       left_out={"TestFMTraining": ["test_mesh_matches_single_device"]})


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _data(n=1500, F=7, seed=0, regression=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    m = 1.5 * X[:, 0] * X[:, 1] - X[:, 2] * X[:, 3] + 0.5 * X[:, 4]
    y = m.astype(np.float32) if regression else (m > 0).astype(np.float32)
    return X, y


def _params(model):
    """A model's parameters as host numpy arrays (either package)."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in model.params.items()}


def _close(tm, jm, rtol=RTOL, atol=ATOL):
    a, b = _params(tm), _params(jm)
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_initial_v_bit_equal():
    jm, tm = JaxFM(n_factors=5, seed=7), FM(device="cpu", n_factors=5,
                                           seed=7)
    jm._init_state(11)
    tm._init_state(11)
    np.testing.assert_array_equal(_params(tm)["v"], _params(jm)["v"])
    assert not _params(tm)["w"].any() and float(_params(tm)["w0"]) == 0.0


@pytest.mark.parametrize("objective", ["binary:logistic",
                                       "reg:squarederror"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_matches_jax(objective, weighted):
    X, y = _data(regression=objective == "reg:squarederror")
    weight = (np.random.default_rng(3).uniform(0, 2, len(y)).astype(
        np.float32) if weighted else None)
    kw = dict(n_factors=4, n_epochs=3, batch_size=256, seed=2,
              learning_rate=0.05, objective=objective)
    jm = JaxFM(**kw).fit(X, y, weight=weight)
    tm = FM(device="cpu", **kw).fit(X, y, weight=weight)
    _close(tm, jm)
    np.testing.assert_allclose(tm.last_loss, jm.last_loss, rtol=RTOL)
    assert int(tm._opt["t"]) == int(jm._opt["t"]) == 3 * 6
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_params_from_numpy_continues_jax_trajectory():
    """JAX's state after one epoch, given to the port with its Adam
    moments and step: both continue two more epochs alike."""
    X, y = _data(seed=5)
    kw = dict(n_factors=3, n_epochs=1, batch_size=200, seed=4)
    jm = JaxFM(**kw).fit(X, y)
    tm = FM(device="cpu", **kw)
    tm.params_from_numpy(gather_tree(jm.params), {
        "m": gather_tree(jm._opt["m"]), "s": gather_tree(jm._opt["s"]),
        "t": int(np.asarray(jm._opt["t"]))})
    np.testing.assert_array_equal(_params(tm)["v"], _params(jm)["v"])
    for _ in range(2):
        jm.fit(X, y)
        tm.fit(X, y)
    _close(tm, jm)
    with pytest.raises(Error):
        tm.params_from_numpy({"w": np.zeros(3)})


def test_model_files_cross_load_and_resume(tmp_path):
    X, y = _data(n=700, seed=8)
    kw = dict(n_factors=4, n_epochs=2, batch_size=128, seed=1)
    jm = JaxFM(**kw).fit(X, y)
    tm = FM(device="cpu", **kw).fit(X, y)
    jm.save_model(str(tmp_path / "jax.model"))
    tm.save_model(str(tmp_path / "port.model"))
    from_jax = FM.load_model(str(tmp_path / "jax.model"), device="cpu")
    from_port = JaxFM.load_model(str(tmp_path / "port.model"))
    for a, b in ((from_jax, jm), (tm, from_port)):
        pa, pb = _params(a), _params(b)
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
        assert int(a._opt["t"]) == int(np.asarray(b._opt["t"]))
        np.testing.assert_allclose(a.predict(X), b.predict(X), rtol=1e-6,
                                   atol=1e-7)
    # a loaded file resumes the same trajectory (Adam's state restored)
    from_jax.fit(X, y)
    jm.fit(X, y)
    _close(from_jax, jm)


def test_fit_iter_equals_fit_on_one_page():
    X, y = _data(n=600, seed=9)
    kw = dict(device="cpu", n_factors=3, n_epochs=2, batch_size=100, seed=6)
    it = FM(**kw).fit_iter(ArrayRowIter(X, y, page_rows=600))
    # fit permutes, fit_iter keeps the page order: compare with JAX's
    # fit_iter over the same page instead
    from dmlc_core_tpu.data.iter import ArrayRowIter as JaxArrayRowIter

    jm = JaxFM(**{k: v for k, v in kw.items() if k != "device"})
    jm.fit_iter(JaxArrayRowIter(X, y, page_rows=600))
    _close(it, jm)


def test_fit_ps_waits_for_the_kvstore():
    """``fit_ps`` over the port's dist_async KVStore (an in-process
    scheduler and two servers): the finalized ``w0``, ``w`` and ``v`` are
    the fleet's, on the model's device, and ``predict`` uses them."""
    import threading

    from dmlc_core_tpu_torch.parallel.kvstore import DistAsyncKVStore
    from dmlc_core_tpu_torch.parallel.ps import (PSClient, PSScheduler,
                                                 PSServer)

    X, y = _data(n=300, seed=4)
    sched = PSScheduler("127.0.0.1", nworker=1, nserver=2)
    sched.start()
    servers = [PSServer("127.0.0.1", sched.port, server_id=i)
               for i in range(2)]
    threads = []
    for srv in servers:
        srv.start()
        threads.append(threading.Thread(target=srv.serve_forever,
                                        daemon=True))
        threads[-1].start()
    kv = DistAsyncKVStore(PSClient(root_uri="127.0.0.1",
                                   root_port=sched.port, rank=0),
                          learning_rate=0.1)
    m = FM(device="cpu", n_factors=3, n_epochs=2, seed=1)
    m.fit_ps(ArrayRowIter(X, y, page_rows=100), kv, batch_rows=50)
    F = X.shape[1]
    w = kv.pull_sparse("fm:w", np.arange(F + 1, dtype=np.int64))
    v = kv.pull_sparse("fm:v", np.arange(F, dtype=np.int64))
    kv.close()
    for th in threads:
        th.join(timeout=30)
    sched.join(timeout=30)
    assert m.params["w"].numpy().tobytes() == w[:-1].tobytes()
    assert m.params["v"].numpy().tobytes() == v.tobytes()
    assert float(m.params["w0"]) == float(w[-1])
    xv = X @ v
    margin = (w[-1] + X @ w[:-1]
              + 0.5 * np.sum(xv * xv - (X * X) @ (v * v), axis=1))
    np.testing.assert_allclose(m.predict(X, output_margin=True), margin,
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(Error):
        FM(device="cpu").fit_ps(None, kv=None, num_col=0)


def test_two_ranks_match_one_process(tmp_path):
    X, y = _data(n=1001, seed=11)
    weight = np.random.default_rng(2).uniform(0, 2, len(y)).astype(
        np.float32)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "w.npy", weight)
    params = dict(n_factors=4, n_epochs=2, batch_size=250, seed=3)
    launch({"X": str(tmp_path / "X.npy"), "y": str(tmp_path / "y.npy"),
            "weight": str(tmp_path / "w.npy"), "backend": "gloo",
            "device": "cpu", "params": params,
            "runs": [{"name": "fm", "model": "fm"}],
            "out": str(tmp_path / "out")}, world=2, timeout=120)
    one = FM(device="cpu", **params).fit(X, y, weight=weight)
    for r in range(2):
        two = FM.load_model(str(tmp_path / "out" / f"fm.{r}.model"),
                            device="cpu")
        _close(two, one)
        assert int(two._opt["t"]) == int(one._opt["t"])
