"""Streamed ingest in the port, against the JAX package, on the CPU.

* ``data.iter.slab_shard_slices`` equals JAX's on a grid of
  ``(lo, length, shard_rows)``;
* ``HistGBT.make_device_data_iter``: its sketch cuts equal JAX's
  ``make_device_data_iter`` cuts on the same slabs, its handle's bins
  (device and host binning) equal ``make_device_data(X, y, cuts=...)``'s,
  a 3-tree ``fit_device`` from each handle writes one file, which loads
  in JAX's ``HistGBT.load_model`` and predicts within 1e-5; every JAX
  refusal is the port's;
* ``data.device_feed.DeviceFeed``: the source's batches in order, a
  rewind by ``before_first``, the producer drained by ``close``,
  ``depth=0`` refused, ``FeedStats.as_dict()`` with JAX's keys, no quiet
  CPU fall back; ``Dataset.device_feed`` yields the dataset's batches;
  the port bench's infeed smoke.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.data.device_feed import FeedStats as JaxFeedStats  # noqa: E402
from dmlc_core_tpu.data.iter import slab_shard_slices as jax_slices  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data import DeviceFeed, FeedStats  # noqa: E402
from dmlc_core_tpu_torch.data.iter import slab_shard_slices  # noqa: E402
from dmlc_core_tpu_torch.stream.dataset import Dataset  # noqa: E402

torch.set_num_threads(2)

KW = dict(n_trees=3, max_depth=4, n_bins=32)


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
              "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS",
              "DMLC_TPU_FUSED_DESCEND", "DMLC_FUSED_ROUND",
              "DMLC_TPU_BIN_BACKEND", "DMLC_TPU_ROUNDS_PER_DISPATCH",
              "DMLC_INGEST_CHUNK_ROWS"):
        monkeypatch.delenv(k, raising=False)


def _rows(n=2500, F=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.7 * np.abs(X[:, 3])
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return X, (z > 0).astype(np.float32), w


X, Y, W = _rows()
SLAB = 600                              # 5 slabs, the last short


def _slabs(X=X, y=Y, w=W, slab=SLAB):
    def source():
        for lo in range(0, len(X), slab):
            yield (X[lo:lo + slab], y[lo:lo + slab],
                   None if w is None else w[lo:lo + slab])
    return source


def _bytes(model, tmp_path, name):
    path = str(tmp_path / f"{name}.model")
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# slab_shard_slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard_rows", [1, 3, 7, 64, 1000])
def test_slab_shard_slices_equal_jax(shard_rows):
    for lo in (0, 1, 5, 63, 64, 999, 1000, 4095):
        for length in (0, 1, 2, 7, 64, 65, 1000, 3001):
            got = slab_shard_slices(lo, length, shard_rows)
            assert got == jax_slices(lo, length, shard_rows)
            covered = sum(hi - s for _, s, hi, _ in got)
            assert covered == length


# ---------------------------------------------------------------------------
# make_device_data_iter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_sketch_cuts_equal_jax(weighted):
    w = W if weighted else None
    m = HistGBT(device="cpu", **KW)
    dd = m.make_device_data_iter(_slabs(w=w))
    jm = JaxHistGBT(mesh=local_mesh(1), **KW)
    jm.make_device_data_iter(_slabs(w=w))
    assert m.cuts.numpy().tobytes() == np.asarray(jm.cuts).tobytes()
    assert dd["n"] == dd["n_global"] == len(X) and dd["n_features"] == 5
    assert m.last_feed_stats["batches"] == 5


@pytest.mark.parametrize("host_bin", [False, True])
def test_handle_equals_make_device_data_and_trains_its_file(
        host_bin, tmp_path, monkeypatch):
    if host_bin:
        monkeypatch.setenv("DMLC_TPU_BIN_BACKEND", "cpu")
    a = HistGBT(device="cpu", **KW)
    dd = a.make_device_data_iter(_slabs())
    b = HistGBT(device="cpu", **KW)
    ref = b.make_device_data(X, Y, weight=W, cuts=a.cuts)
    assert sorted(dd) == sorted(ref)
    assert dd["bins_t"].dtype == torch.uint8
    assert torch.equal(dd["bins_t"], ref["bins_t"])
    assert torch.equal(dd["y_d"], ref["y_d"])
    assert torch.equal(dd["w_d"], ref["w_d"])
    assert dd["layout"] is None
    a.fit_device(dd)
    b.fit_device(ref)
    fa = _bytes(a, tmp_path, "iter")
    assert fa == _bytes(b, tmp_path, "incore")
    jm = JaxHistGBT.load_model(str(tmp_path / "iter.model"))
    np.testing.assert_allclose(
        np.asarray(jm.predict(X, output_margin=True)),
        a.predict(X, output_margin=True), rtol=0, atol=1e-5)


def test_one_pass_with_cuts_rows_and_width(tmp_path):
    a = HistGBT(device="cpu", **KW)
    full = a.make_device_data_iter(_slabs(w=None))
    slabs = list(_slabs(w=None)())              # a plain iterable
    b = HistGBT(device="cpu", **KW)
    dd = b.make_device_data_iter(slabs, n_features=5, cuts=a.cuts.numpy(),
                                 n_rows=len(X))
    assert torch.equal(dd["bins_t"], full["bins_t"])
    a.fit_device(full)
    b.fit_device(dd)
    assert _bytes(a, tmp_path, "a") == _bytes(b, tmp_path, "b")


def test_softmax_handle_trains_the_in_core_file(tmp_path):
    y3 = (np.digitize(X[:, 0], [-0.5, 0.5])).astype(np.float32)
    kw = dict(KW, objective="multi:softmax", num_class=3)
    a = HistGBT(device="cpu", **kw)
    a.fit_device(a.make_device_data_iter(_slabs(y=y3, w=None)))
    b = HistGBT(device="cpu", **kw)
    b.fit_device(b.make_device_data(X, y3, cuts=a.cuts))
    assert _bytes(a, tmp_path, "a") == _bytes(b, tmp_path, "b")


def _nan_slabs():
    Xn = X.copy()
    Xn[7, 2] = np.nan
    return _slabs(X=Xn)


REFUSALS = {
    "nan": (lambda m: m.make_device_data_iter(_nan_slabs()),
            "NaN features are only supported by the in-core fit"),
    "not_callable": (lambda m: m.make_device_data_iter(
        list(_slabs()()), n_features=5),
        "slab_source must be a callable"),
    "declared_rows": (lambda m: m.make_device_data_iter(
        _slabs(), n_rows=len(X) + 1), "declared n_rows != streamed rows"),
    "empty": (lambda m: m.make_device_data_iter(lambda: iter([])),
              "empty input"),
    "cut_width": (lambda m: m.make_device_data_iter(
        _slabs(), cuts=np.zeros((5, 30), np.float32)),
        "standard mode"),
    "cut_features": (lambda m: m.make_device_data_iter(
        _slabs(), cuts=np.zeros((4, 31), np.float32)),
        "cuts width does not match"),
    "more_rows": (lambda m: m.make_device_data_iter(
        list(_slabs()()), n_features=5, n_rows=100,
        cuts=np.sort(np.random.default_rng(0).normal(
            size=(5, 31)), axis=1).astype(np.float32)),
        "produced more than the declared"),
    "fewer_rows": (lambda m: m.make_device_data_iter(
        list(_slabs()())[:2], n_features=5, n_rows=len(X),
        cuts=np.sort(np.random.default_rng(0).normal(
            size=(5, 31)), axis=1).astype(np.float32)),
        "ended before the declared rows"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_are_jax_refusals(name):
    call, msg = REFUSALS[name]
    with pytest.raises(Error, match=msg):
        call(HistGBT(device="cpu", **KW))
    with pytest.raises(JaxError, match=msg):
        call(JaxHistGBT(mesh=local_mesh(1), **KW))


def test_missing_mode_and_several_ranks_refused(monkeypatch):
    Xn = X.copy()
    Xn[::7, 1] = np.nan
    m = HistGBT(device="cpu", **KW).fit(Xn, Y)
    assert m._missing
    with pytest.raises(Error, match="does not support missing mode"):
        m.make_device_data_iter(_slabs())
    jm = JaxHistGBT(mesh=local_mesh(1), **KW)
    jm.fit(Xn, Y)
    with pytest.raises(JaxError, match="does not support missing mode"):
        jm.make_device_data_iter(_slabs())
    from dmlc_core_tpu_torch.parallel import collectives as coll

    monkeypatch.setattr(coll, "world_size", lambda: 2)
    with pytest.raises(Error, match="use fit_external for multi-worker"):
        HistGBT(device="cpu", **KW).make_device_data_iter(_slabs())


# ---------------------------------------------------------------------------
# DeviceFeed
# ---------------------------------------------------------------------------

def _batches(k=5):
    def source():
        for i in range(k):
            yield np.full(16, i, np.float32)
    return source


def test_feed_yields_in_order_and_rewinds():
    with DeviceFeed(_batches(), "cpu", depth=2) as feed:
        vals = [float(b[0]) for b in feed]
        assert vals == [0, 1, 2, 3, 4]
        assert feed.stats.batches == 5
        assert feed.stats.bytes == 5 * 16 * 4
        assert all(isinstance(b, torch.Tensor) for b in feed)
        feed.before_first()
        assert [float(b[0]) for b in feed] == vals


def test_feed_nested_batches_and_plain_iterables():
    src = [(np.zeros((8, 4), np.float32),
            {"y": np.arange(8, dtype=np.int32)})] * 3
    with DeviceFeed(src, torch.device("cpu"), depth=1) as feed:
        out = list(feed)
    assert len(out) == 3
    x, d = out[0]
    assert x.shape == (8, 4) and d["y"].tolist() == list(range(8))
    assert d["y"].dtype == torch.int32


def test_feed_close_drains_the_producer():
    feed = DeviceFeed(_batches(100), "cpu", depth=2, host_prefetch=2)
    it = iter(feed)
    assert float(next(it)[0]) == 0
    feed.close()
    assert not feed._titer._thread.is_alive()
    rest = list(it)                   # only what was already in flight
    assert len(rest) <= 2
    assert list(feed) == []


def test_feed_refusals_and_stats_keys():
    with pytest.raises(Error, match="depth must be >= 1"):
        DeviceFeed(_batches(), "cpu", depth=0)
    assert sorted(FeedStats().as_dict()) == sorted(JaxFeedStats().as_dict())
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(Error, match="no CUDA GPU"):
                DeviceFeed(_batches(), dev)
        from dmlc_core_tpu_torch.parallel.mesh import local_mesh as tmesh

        with pytest.raises(Error, match="no CUDA GPU"):
            DeviceFeed(_batches(), tmesh())


def test_feed_producer_exception_propagates():
    def source():
        yield np.zeros(8, np.float32)
        raise ValueError("boom in parser")

    with DeviceFeed(source, "cpu") as feed, pytest.raises(ValueError):
        for _ in feed:
            pass


def test_dataset_device_feed_yields_its_batches():
    items = [np.full(4, i, np.float32) for i in range(6)]
    ds = Dataset.from_iterable(items)
    with ds.device_feed("cpu", depth=2, host_prefetch=2) as feed:
        got = [b.tolist() for b in feed]
    assert got == [a.tolist() for a in items]


def test_bench_infeed_smoke_on_the_cpu():
    from dmlc_core_tpu_torch import bench

    frac = bench._smoke_infeed(torch.device("cpu"))
    assert 0.0 <= frac <= 1.0
