"""Out-of-core training (``fit_external``) and streaming prediction
(``predict_iter``) in the port, against the JAX package, on the CPU.

* ``ops.quantile.SketchAccumulator``: cuts bit-equal to the JAX
  package's (pages, weights, atoms, a deep merge ladder, a two-worker
  merge);
* with nothing sampled, the cached route, the chunked route (4 chunks,
  the bins uploaded per level) and the in-core ``fit(X, y, cuts=)`` write
  byte-identical model files — binary, weighted, squared error, softmax;
* against JAX's ``fit_external`` (its cached and its chunked route):
  parity level (b) by ``tests/_torch_parity.py``'s float64 proofs, also
  sampled, where the masks are JAX's numpy draws (``_ext_sample_masks``
  is held to them bit for bit) and a sampled fit does not depend on the
  chunking;
* ``predict_iter`` equals ``predict`` bit for bit over ``ArrayRowIter``
  and ``#cache`` libsvm pages; a page wider than the cuts fails;
* a libsvm file written with ``%.9g`` (absent entries read as 0.0) and
  read back through ``RowBlockIter.create("…#cache")`` densifies to the
  same bits and, with the same cuts (the cache's pages are not the
  array's, and the sketch summarises pages), trains the file of the same
  rows' ``ArrayRowIter``;
* a continued fit through the chunked route writes the uninterrupted
  fit's file; JAX's refusals with JAX's messages; two gloo ranks, each
  with its own pages, write the one-process chunked file.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import assert_level_b_f64  # noqa: E402
from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.data.iter import ArrayRowIter as JaxArrayRowIter  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.ops.quantile import (  # noqa: E402
    SketchAccumulator as JaxSketch)
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data.iter import ArrayRowIter, RowBlockIter  # noqa: E402
from dmlc_core_tpu_torch.ops.quantile import SketchAccumulator  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import launch  # noqa: E402

torch.set_num_threads(2)

BUDGET = "DMLC_TPU_EXTERNAL_DEVICE_BUDGET"
KW = dict(n_trees=4, max_depth=4, n_bins=32)


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
              "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS",
              "DMLC_TPU_FUSED_DESCEND", "DMLC_FUSED_ROUND",
              "DMLC_TPU_BIN_BACKEND", "DMLC_TPU_ROUNDS_PER_DISPATCH", BUDGET):
        monkeypatch.delenv(k, raising=False)


def _rows(n=3000, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.7 * np.abs(X[:, 3])
    return X, z.astype(np.float32)


X, Z = _rows()
XV, _ = _rows(800, seed=5)
Y = (Z > 0).astype(np.float32)
Y3 = np.digitize(Z, np.quantile(Z, [1 / 3, 2 / 3])).astype(np.float32)
PAGE = 700                                     # 5 pages, the last short


def _bytes(model, tmp_path, name="m"):
    path = str(tmp_path / f"{name}.model")
    model.save_model(path)
    with open(path, "rb") as f:
        return f.read()


def _chunk_budget(n, F, K=1, chunks=4):
    """A budget whose chunked route cuts ``n`` rows into ``chunks``."""
    return n * (12 + 12 * K) + F * -(-n // chunks)


# -- the sketch ------------------------------------------------------------

SKETCHES = {
    "pages": dict(n=20_000, F=5, pages=23, S=512, cap=4, w=False),
    "weighted": dict(n=8_000, F=3, pages=7, S=256, cap=8, w=True),
    "atoms": dict(n=6_000, F=2, pages=11, S=128, cap=4, w=False, atoms=True),
    "ladder": dict(n=40_000, F=1, pages=400, S=256, cap=4, w=False),
}


@pytest.mark.parametrize("case", list(SKETCHES))
def test_sketch_cuts_bit_equal(case):
    c = SKETCHES[case]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((c["n"], c["F"])).astype(np.float32)
    if c.get("atoms"):
        x[: c["n"] * 9 // 10] = np.float32(3.25)
    w = rng.random(c["n"]).astype(np.float32) if c["w"] else None
    jax_s = JaxSketch(c["F"], n_summary=c["S"], buffer_pages=c["cap"])
    port_s = SketchAccumulator(c["F"], n_summary=c["S"],
                               buffer_pages=c["cap"], device="cpu")
    for idx in np.array_split(np.arange(c["n"]), c["pages"]):
        for s in (jax_s, port_s):
            s.add(x[idx], None if w is None else w[idx])
    assert port_s.pages_seen == jax_s.pages_seen
    assert [len(lv) for lv in port_s._levels] == \
        [len(lv) for lv in jax_s._levels]
    a = np.asarray(jax_s.finalize(32))
    b = port_s.finalize(32).numpy()
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sketch_two_worker_merge_bit_equal():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6000, 3)).astype(np.float32)
    out = []
    for make in (lambda: JaxSketch(3, n_summary=256, buffer_pages=4),
                 lambda: SketchAccumulator(3, n_summary=256, buffer_pages=4,
                                           device="cpu")):
        halves = [make(), make()]
        for h, rows in zip(halves, np.array_split(np.arange(6000), 2)):
            for pg in np.array_split(rows, 5):
                h.add(x[pg])

        def gather(arr, _h=halves):
            if np.ndim(arr) == 2:
                return np.stack([np.asarray(s.summary()[0]) for s in _h])
            return np.asarray([s.summary()[1] for s in _h], np.float32)

        out.append(np.asarray(halves[0].finalize(16, gather)))
    assert out[0].tobytes() == out[1].tobytes()


# -- routes: one file --------------------------------------------------------

ROUTES = {
    "binary": (dict(), Y, None),
    "weighted": (dict(scale_pos_weight=3.0), Y, None),
    "squarederror": (dict(objective="reg:squarederror"), Z, None),
    "softmax": (dict(objective="multi:softmax", num_class=3), Y3, None),
    "page_weights": (dict(), Y, np.linspace(0.5, 2.0, len(Y),
                                            dtype=np.float32)),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_cached_chunked_and_in_core_write_one_file(case, tmp_path,
                                                    monkeypatch):
    extra, y, w = ROUTES[case]
    kw = dict(KW, **extra)
    cached = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, y, w, page_rows=PAGE))
    assert cached.last_external_route == "cached"
    monkeypatch.setenv(BUDGET, str(_chunk_budget(len(y), X.shape[1],
                                                 kw.get("num_class", 1))))
    chunked = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, y, w, page_rows=PAGE))
    monkeypatch.delenv(BUDGET)
    assert chunked.last_external_route == "chunked"
    assert chunked.last_external_chunks == 4
    # every level and the final advance upload each chunk once a tree
    trees = kw["n_trees"] * kw.get("num_class", 1)
    assert chunked.last_upload_bytes == trees * (kw["max_depth"] + 1) * \
        X.size
    incore = HistGBT(device="cpu", **kw).fit(X, y, w,
                                             cuts=cached.cuts.numpy())
    ref = _bytes(incore, tmp_path, "incore")
    assert _bytes(cached, tmp_path, "cached") == ref
    assert _bytes(chunked, tmp_path, "chunked") == ref
    np.testing.assert_array_equal(chunked.predict(XV), incore.predict(XV))


# -- against JAX's fit_external ------------------------------------------------

def _jax_external(y, kw, budget=None, monkeypatch=None, w=None):
    if budget is not None:
        monkeypatch.setenv(BUDGET, str(budget))
    m = JaxHistGBT(mesh=local_mesh(1), hist_method="segment",
                   **kw).fit_external(JaxArrayRowIter(X, y, w, page_rows=PAGE))
    if budget is not None:
        monkeypatch.delenv(BUDGET)
    return m


@pytest.mark.parametrize("route", ["cached", "chunked"])
@pytest.mark.parametrize("case", ["binary", "softmax"])
def test_meets_level_b_against_jax(route, case, monkeypatch):
    extra, y, w = ROUTES[case]
    kw = dict(KW, **extra)
    budget = (_chunk_budget(len(y), X.shape[1], kw.get("num_class", 1))
              if route == "chunked" else None)
    jm = _jax_external(y, kw, budget, monkeypatch)
    if budget is not None:
        monkeypatch.setenv(BUDGET, str(budget))
    tm = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, y, page_rows=PAGE))
    assert tm.last_external_route == route
    assert np.asarray(jm.cuts).tobytes() == tm.cuts.numpy().tobytes()
    assert assert_level_b_f64(jm, tm, X, y, XV)[1] is None


def _numpy_masks(p, r, page_rows, F, rank=0):
    """The JAX chunked route's draws, as its round loop writes them."""
    crng = np.random.default_rng([p["seed"], r, 1])
    n_keep = max(1, int(np.ceil(p["colsample_bytree"] * F)))
    scores = crng.random(F)
    fmask = scores <= np.sort(scores)[n_keep - 1]
    rrng = np.random.default_rng([p["seed"], r, 2, rank])
    keep = np.concatenate([(rrng.random(pr) < p["subsample"]
                            ).astype(np.float32) for pr in page_rows])
    return keep, fmask


SAMPLED = dict(KW, subsample=0.8, colsample_bytree=0.7, seed=3)


def test_sampling_draws_are_jax_numpy_draws():
    m = HistGBT(device="cpu", **SAMPLED)
    pages = [PAGE] * 4 + [200]
    for r in range(6):
        keep, fmask = m._ext_sample_masks(r, pages, 6)
        k2, f2 = _numpy_masks(SAMPLED, r, pages, 6)
        assert keep.tobytes() == k2.tobytes()
        np.testing.assert_array_equal(fmask, f2)


def test_sampled_chunked_fit_meets_level_b(tmp_path, monkeypatch):
    jm = _jax_external(Y, SAMPLED)                # JAX: always chunked
    one = HistGBT(device="cpu", **SAMPLED).fit_external(
        ArrayRowIter(X, Y, page_rows=PAGE))
    assert one.last_external_route == "chunked"
    assert one.last_external_chunks == 1
    pages = [PAGE] * 4 + [len(Y) - 4 * PAGE]
    assert_level_b_f64(jm, one, X, Y, XV, masks=lambda t: _numpy_masks(
        SAMPLED, t, pages, X.shape[1]))
    # the draws follow the pages, not the chunks
    monkeypatch.setenv(BUDGET, str(_chunk_budget(len(Y), X.shape[1])))
    four = HistGBT(device="cpu", **SAMPLED).fit_external(
        ArrayRowIter(X, Y, page_rows=PAGE))
    assert four.last_external_chunks == 4
    assert _bytes(four, tmp_path, "4") == _bytes(one, tmp_path, "1")


# -- the options: cache_device, warmup_rounds, sketch_pages --------------------

@pytest.mark.parametrize("sampled", [False, True])
def test_cache_device_takes_the_cached_route(sampled, tmp_path,
                                             monkeypatch):
    kw = SAMPLED if sampled else KW
    # a budget that would cut the rows into 4 chunks; sampling alone
    # would take the chunked route too
    monkeypatch.setenv(BUDGET, str(_chunk_budget(len(Y), X.shape[1])))
    m = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, Y, page_rows=PAGE), cache_device=True)
    assert m.last_external_route == "cached"
    # the in-core loop on the same bins: the in-core fit's file, its
    # threefry draws where sampled (the JAX package's cache_device rule)
    incore = HistGBT(device="cpu", **kw).fit(X, Y, cuts=m.cuts.numpy())
    assert _bytes(m, tmp_path, "c") == _bytes(incore, tmp_path, "i")
    np.testing.assert_array_equal(m.train_margins(), incore.train_margins())


@pytest.mark.parametrize("route", ["cached", "chunked"])
def test_warmup_rounds_keep_the_file(route, tmp_path, monkeypatch):
    if route == "chunked":
        monkeypatch.setenv(BUDGET, str(_chunk_budget(len(Y), X.shape[1])))
    kw = SAMPLED if route == "chunked" else KW
    grown = []
    grow = HistGBT._grow_tree
    monkeypatch.setattr(HistGBT, "_grow_tree", lambda self, *a, **k: (
        grown.append(1), grow(self, *a, **k))[1])
    plain = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, Y, page_rows=PAGE))
    assert len(grown) == kw["n_trees"]
    warm = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, Y, page_rows=PAGE), warmup_rounds=1)
    assert warm.last_external_route == route
    assert len(grown) == 2 * kw["n_trees"] + 1      # one discarded round
    assert _bytes(warm, tmp_path, "w") == _bytes(plain, tmp_path, "p")
    # the warm-up's uploads are not the kept rounds'
    assert warm.last_upload_bytes == plain.last_upload_bytes


def test_sketch_pages_is_the_sketch_buffer(tmp_path):
    """``sketch_pages`` is the sketch's ``buffer_pages``: with 2 the 5
    pages climb the merge ladder, and the cuts stay the JAX sketch's."""
    kw = dict(KW, n_trees=1)
    B = kw["n_bins"]
    cuts = []
    for pages in (2, 32):
        m = HistGBT(device="cpu", **kw).fit_external(
            ArrayRowIter(X, Y, page_rows=PAGE), sketch_pages=pages)
        js = JaxSketch(X.shape[1], n_summary=max(8 * B, 64),
                       buffer_pages=pages)
        for lo in range(0, len(Y), PAGE):
            js.add(X[lo:lo + PAGE], None)
        assert np.asarray(js.finalize(B)).tobytes() == \
            m.cuts.numpy().tobytes()
        cuts.append(m.cuts.numpy())
    assert not np.array_equal(cuts[0], cuts[1])     # the option is used


# -- predict_iter, libsvm pages ----------------------------------------------

def _write_libsvm(path, X, y, drop_zeros=False):
    """Rows as libsvm text, f32 values round-tripping exactly (``%.9g``);
    with ``drop_zeros`` the 0.0 entries are left out (read back as 0.0)."""
    with open(path, "w") as f:
        for i in range(len(X)):
            feats = " ".join(f"{j}:{X[i, j]:.9g}" for j in range(X.shape[1])
                             if not (drop_zeros and X[i, j] == 0.0))
            f.write(f"{y[i]:.9g} {feats}\n")


def test_predict_iter_equals_predict(tmp_path):
    m = HistGBT(device="cpu", **KW).fit(X, Y)
    for batch in (257, 100_000):
        got = m.predict_iter(ArrayRowIter(XV, np.zeros(len(XV), np.float32),
                                          page_rows=300), batch_rows=batch)
        assert got.tobytes() == m.predict(XV).tobytes()
    data = str(tmp_path / "v.libsvm")
    _write_libsvm(data, XV, np.zeros(len(XV)))
    it = RowBlockIter.create(data + "#" + str(tmp_path / "v.cache"), 0, 1,
                             "libsvm")
    got = m.predict_iter(it, output_margin=True, batch_rows=333)
    it.close()
    assert got.tobytes() == m.predict(XV, output_margin=True).tobytes()
    s = HistGBT(device="cpu", objective="multi:softmax", num_class=3,
                **KW).fit(X, Y3)
    got = s.predict_iter(ArrayRowIter(XV, np.zeros(len(XV), np.float32)),
                         output_margin=True)
    assert got.tobytes() == s.predict(XV, output_margin=True).tobytes()


def test_predict_iter_wider_page_fails():
    m = HistGBT(device="cpu", **KW).fit(X[:, :3], Y)
    with pytest.raises(Error, match="expects 3 features"):
        m.predict_iter(ArrayRowIter(X, Y))


def test_disk_pages_train_the_array_pages_file(tmp_path):
    Xz = X.copy()
    Xz[np.abs(Xz) < 0.2] = 0.0                # absent from the text
    data = str(tmp_path / "t.libsvm")
    _write_libsvm(data, Xz, Y, drop_zeros=True)
    arr = HistGBT(device="cpu", **KW).fit_external(
        ArrayRowIter(Xz, Y, page_rows=PAGE))
    it = RowBlockIter.create(data + "#" + str(tmp_path / "t.cache"), 0, 1,
                             "libsvm")
    dense = np.concatenate([b.to_dense(X.shape[1]) for b in it])
    assert dense.tobytes() == Xz.tobytes()      # the text loses no bit
    # the sketch summarises pages, and the cache pages by bytes: the
    # same cuts make the same bins
    disk = HistGBT(device="cpu", **KW).fit_external(
        it, num_col=X.shape[1], cuts=arr.cuts.numpy())
    it.close()
    assert _bytes(disk, tmp_path, "disk") == _bytes(arr, tmp_path, "arr")


# -- continued fits, refusals, ranks --------------------------------------------

@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softmax"])
def test_chunked_resume_writes_the_uninterrupted_file(objective, tmp_path,
                                                      monkeypatch):
    kw = dict(KW, n_trees=5, objective=objective)
    y = Y
    if objective == "multi:softmax":
        kw["num_class"] = 3
        y = Y3
    monkeypatch.setenv(BUDGET, str(_chunk_budget(len(y), X.shape[1],
                                                 kw.get("num_class", 1))))
    full = HistGBT(device="cpu", **kw).fit_external(
        ArrayRowIter(X, y, page_rows=PAGE))
    part = HistGBT(device="cpu", **dict(kw, n_trees=3)).fit_external(
        ArrayRowIter(X, y, page_rows=PAGE))
    path = str(tmp_path / "part.model")
    part.save_model(path)
    resumed = HistGBT.load_model(path, device="cpu")
    resumed.param.n_trees = 2
    resumed.fit_external(ArrayRowIter(X, y, page_rows=PAGE),
                         cuts=resumed.cuts.numpy())
    assert resumed.last_external_route == "chunked"
    resumed.param.n_trees = 5
    assert _bytes(resumed, tmp_path, "r") == _bytes(full, tmp_path, "f")


def test_refusals_have_jax_messages():
    it = lambda: ArrayRowIter(X[:200], Y[:200])           # noqa: E731
    jit = lambda: JaxArrayRowIter(X[:200], Y[:200])       # noqa: E731
    cases = [
        (dict(monotone_constraints=[1, 0, 0, 0, 0, 0]),
         "monotone_constraints not supported"),
        (dict(objective="rank:ndcg"), "needs the grouped in-core"),
        (dict(objective="reg:squarederror", scale_pos_weight=2.0),
         "scale_pos_weight only applies"),
    ]
    for kw, msg in cases:
        with pytest.raises(Error, match=msg):
            HistGBT(device="cpu", **kw).fit_external(it())
        with pytest.raises(JaxError, match=msg):
            JaxHistGBT(mesh=local_mesh(1), **kw).fit_external(jit())
    Xn = X[:200].copy()
    Xn[3, 2] = np.nan
    with pytest.raises(Error, match="NaN features are only supported"):
        HistGBT(device="cpu", **KW).fit_external(ArrayRowIter(Xn, Y[:200]))
    with pytest.raises(JaxError, match="NaN features are only supported"):
        JaxHistGBT(mesh=local_mesh(1), **KW).fit_external(
            JaxArrayRowIter(Xn, Y[:200]))
    miss = HistGBT(device="cpu", **KW).fit(Xn, Y[:200])
    with pytest.raises(Error, match="trained in missing mode"):
        miss.fit_external(it())


def test_budget_below_the_row_state_fails(monkeypatch):
    monkeypatch.setenv(BUDGET, "1000")
    with pytest.raises(Error, match="cannot hold"):
        HistGBT(device="cpu", **SAMPLED).fit_external(ArrayRowIter(X, Y))


def test_two_ranks_write_the_one_process_chunked_file(tmp_path):
    d = tmp_path
    np.save(d / "X.npy", X)
    np.save(d / "y.npy", Y)
    cuts = HistGBT(device="cpu", **KW).fit_external(
        ArrayRowIter(X, Y, page_rows=PAGE)).cuts.numpy()
    np.save(d / "cuts.npy", cuts)
    for world in (1, 2):
        launch({"X": str(d / "X.npy"), "y": str(d / "y.npy"),
                "cuts": str(d / "cuts.npy"), "backend": "gloo",
                "device": "cpu", "threads": 1, "params": KW,
                "runs": [{"name": "ext", "external": {"page_rows": PAGE}},
                         {"name": "ext_cache", "external": {
                             "page_rows": PAGE, "cache_device": True}}],
                "out": str(d / f"w{world}")}, world=world, timeout=180)
    one = (d / "w1" / "ext.0.model").read_bytes()
    # cache_device=True: the cached route on one rank, the chunked route
    # with every row resident on two
    assert (d / "w1" / "ext_cache.0.model").read_bytes() == one
    for r in range(2):
        for name in ("ext", "ext_cache"):
            assert (d / "w2" / f"{name}.{r}.model").read_bytes() == one
    # one process takes the cached route, two ranks the chunked one:
    # both write the in-core file
    m = HistGBT(device="cpu", **KW).fit(X, Y, cuts=cuts)
    assert _bytes(m, tmp_path, "incore") == one
