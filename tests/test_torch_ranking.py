"""``rank:pairwise`` / ``rank:ndcg`` / ``rank:map`` with ``fit(qid=)`` in
the port, against the JAX package, on the CPU.

* ``models/ranking.py`` (``ndcg``, ``mean_average_precision``,
  ``pairwise_accuracy``): JAX's ``TestRankingMetrics`` cases run against
  both packages' copies;
* the objectives' g/h within rtol 1e-5 / atol 1e-6 of JAX's on the same
  padded query blocks (JAX computes in f32; the port in float64, rounded
  once, so that the CPU and the GPU give the same bits), the lambda
  weights against the brute-force swap-and-rescore oracle of
  ``tests/test_ranking.py``, blocks of queries change nothing;
* fits on ``tests/test_ranking.py``'s problems meet parity level (b)
  (``tests/_torch_parity.py``'s float64 proofs, on the padded layout),
  their files cross-load both ways (level (c)), truncation by
  ``max_group_size`` and ``train_margins``' unwinding match JAX's;
* JAX's refusals (no ``qid``, ``eval_set``, a continued fit) with JAX's
  messages;
* 1, 2 and 4 gloo ranks: with a query count divisible by 4 every world
  writes the 1-rank file; with 30 queries 4 ranks pad two empty queries
  (y = −1, weight 0), which leave the weighted cuts alone and here the
  width of the fixed-point scale's row count too, so every world still
  writes the 1-rank file and margins — stronger than JAX's
  ``test_mesh_matches_single_device`` (equal first trees, margins within
  1e-4).  A pad that widened that row count past a power of two would
  change the scale, and the bar would then be level (b).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import assert_level_b_through  # noqa: E402
from test_ranking import (  # noqa: E402
    _brute_delta, _graded_ltr_problem, _ltr_problem)
from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models import ranking as jax_ranking  # noqa: E402
from dmlc_core_tpu.models.gbt_objectives import (  # noqa: E402
    OBJECTIVES as JAX_OBJECTIVES)
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import ranking as port_ranking  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_objectives import (  # noqa: E402
    OBJECTIVES)
from dmlc_core_tpu_torch.parallel.launch import launch  # noqa: E402

torch.set_num_threads(2)

RANKS = ("rank:pairwise", "rank:ndcg", "rank:map")
MODULES = {"jax": jax_ranking, "port": port_ranking}


@pytest.fixture(autouse=True)
def _no_levers(monkeypatch):
    for k in ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
              "DMLC_FEATURE_BUNDLE", "DMLC_HIST_BLOCKS",
              "DMLC_TPU_FUSED_DESCEND", "DMLC_FUSED_ROUND",
              "DMLC_TPU_ROUNDS_PER_DISPATCH"):
        monkeypatch.delenv(k, raising=False)


# -- metrics: JAX's TestRankingMetrics, against both copies ---------------

@pytest.mark.parametrize("pkg", list(MODULES))
def test_ndcg_perfect_and_inverted(pkg):
    m = MODULES[pkg]
    y = np.array([2.0, 1.0, 0.0, 0.0])
    qid = np.zeros(4, np.int64)
    assert m.ndcg(y, np.array([4.0, 3.0, 2.0, 1.0]), qid) == 1.0
    inv = m.ndcg(y, np.array([1.0, 2.0, 3.0, 4.0]), qid)
    assert 0.0 < inv < 0.7
    assert m.ndcg(np.zeros(3), np.arange(3.0), np.zeros(3, np.int64)) == 1.0


@pytest.mark.parametrize("pkg", list(MODULES))
def test_map_and_pairwise_accuracy(pkg):
    m = MODULES[pkg]
    y = np.array([1.0, 0.0, 1.0, 0.0])
    qid = np.array([0, 0, 1, 1], np.int64)
    assert m.mean_average_precision(y, np.array([2., 1., 1., 2.]),
                                    qid) == 0.75
    assert m.pairwise_accuracy(y, np.array([2., 1., 1., 2.]), qid) == 0.5


@pytest.mark.parametrize("pkg", list(MODULES))
def test_ndcg_at_k_truncates(pkg):
    m = MODULES[pkg]
    y = np.array([0.0, 0.0, 2.0])
    qid = np.zeros(3, np.int64)
    sc = np.array([3.0, 2.0, 1.0])
    assert m.ndcg(y, sc, qid, k=2) == 0.0
    assert m.ndcg(y, sc, qid) > 0.0


def test_metrics_equal_on_random_queries():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 4, 500).astype(np.float64)
    s = rng.standard_normal(500)
    q = rng.integers(0, 37, 500)
    for fn in ("ndcg", "mean_average_precision", "pairwise_accuracy"):
        assert getattr(port_ranking, fn)(y, s, q) == \
            getattr(jax_ranking, fn)(y, s, q)
    assert port_ranking.ndcg(y, s, q, k=5) == jax_ranking.ndcg(y, s, q, k=5)


# -- objectives ------------------------------------------------------------

def _blocks(Q=40, G=9, seed=0):
    """Padded query blocks: scores with ties, relevance 0-3, pads -1."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.standard_normal((Q, G)), 1).astype(np.float32)
    r = rng.integers(0, 4, (Q, G)).astype(np.float32)
    lens = rng.integers(2, G + 1, Q)
    r[np.arange(G)[None, :] >= lens[:, None]] = -1.0
    return s.reshape(-1), r.reshape(-1)


@pytest.mark.parametrize("name", RANKS)
def test_grad_hess_match_jax(name):
    s, r = _blocks()
    jg, jh = JAX_OBJECTIVES[name](9, 16).grad_hess(jnp.asarray(s),
                                                   jnp.asarray(r))
    pg, ph = OBJECTIVES[name](9, 16).grad_hess(torch.from_numpy(s),
                                               torch.from_numpy(r))
    assert pg.dtype == torch.float32 and pg.shape == (len(s),)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)
    # the block size is a memory bound only
    bg, bh = OBJECTIVES[name](9, 7).grad_hess(torch.from_numpy(s),
                                              torch.from_numpy(r))
    assert torch.equal(bg, pg) and torch.equal(bh, ph)
    jm = float(JAX_OBJECTIVES[name](9).metric(jnp.asarray(s),
                                              jnp.asarray(r)))
    pm = float(OBJECTIVES[name](9).metric(torch.from_numpy(s),
                                          torch.from_numpy(r)))
    assert abs(pm - jm) <= 1e-6 * max(1.0, abs(jm))


@pytest.mark.parametrize("kind", ["ndcg", "map"])
def test_lambda_weights_match_brute_force(kind):
    rng = np.random.default_rng(11)
    G = 9
    obj = OBJECTIVES["rank:" + kind](G)
    for _ in range(5):
        scores = rng.normal(size=G).astype(np.float32)
        rel = rng.integers(0, 4, size=G).astype(np.float32)
        if kind == "map":
            rel = (rel > 1).astype(np.float32)
        sb = torch.from_numpy(scores[None]).double()
        rb = torch.from_numpy(rel[None]).double()
        better = rb[:, :, None] > rb[:, None, :]
        w = obj._pair_weight(sb, rb, better)[0].numpy()
        brute = _brute_delta(scores, rel.astype(np.float64), kind)
        np.testing.assert_allclose(w, brute, rtol=1e-9, atol=1e-12)


# -- fits --------------------------------------------------------------------

@pytest.mark.parametrize("name", RANKS)
def test_fit_meets_level_b_and_cross_loads(name, tmp_path):
    X, y, qid = _ltr_problem(n_queries=32, seed=2)
    Xv, _, _ = _ltr_problem(n_queries=16, seed=7)
    kw = dict(n_trees=5, max_depth=3, n_bins=32, objective=name)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y, qid=qid)
    tm = HistGBT(device="cpu", **kw).fit(X, y, qid=qid)
    assert_level_b_through(jm, tm, X, y, Xv, qid=qid)
    nd = port_ranking.ndcg(y, tm.predict(X), qid, k=5)
    assert nd > 0.8, nd
    # level (c): each package's file in the other
    tp, jp = str(tmp_path / "t.model"), str(tmp_path / "j.model")
    tm.save_model(tp)
    jm.save_model(jp)
    np.testing.assert_array_equal(
        JaxHistGBT.load_model(tp, mesh=local_mesh(1)).predict(Xv),
        tm.predict(Xv))
    np.testing.assert_array_equal(
        HistGBT.load_model(jp, device="cpu").predict(Xv), jm.predict(Xv))


def test_graded_problem_meets_level_b():
    X, y, qid = _graded_ltr_problem(n_queries=24, docs=20, seed=0)
    Xv, _, _ = _graded_ltr_problem(n_queries=8, docs=20, seed=1)
    kw = dict(n_trees=4, max_depth=3, n_bins=32, objective="rank:ndcg")
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y, qid=qid)
    tm = HistGBT(device="cpu", **kw).fit(X, y, qid=qid)
    assert_level_b_through(jm, tm, X, y, Xv, qid=qid)


def test_train_margins_unwind_and_truncation():
    X, y, qid = _ltr_problem(n_queries=16, docs_lo=3, docs_hi=9, seed=5)
    kw = dict(n_trees=5, max_depth=2, n_bins=16, objective="rank:pairwise",
              max_group_size=6)
    tm = HistGBT(device="cpu", **kw).fit(X, y, qid=qid)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y, qid=qid)
    tt, jt = tm.train_margins(), np.asarray(jm.train_margins())
    assert tt.shape == y.shape
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
    kept = ~np.isnan(tt)
    lens = np.bincount(qid.astype(int))
    assert (~kept).sum() == np.maximum(lens - 6, 0).sum()
    np.testing.assert_allclose(tt[kept], tm.predict(X, output_margin=True
                                                    )[kept],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tt[kept], jt[kept], atol=1e-5)


def test_refusals_have_jax_messages():
    X, y, qid = _ltr_problem(n_queries=4, seed=1)
    for make, err in ((lambda **k: HistGBT(device="cpu", **k), Error),
                      (lambda **k: JaxHistGBT(mesh=local_mesh(1), **k),
                       JaxError)):
        with pytest.raises(err, match="rank:ndcg needs qid="):
            make(objective="rank:ndcg").fit(X, y)
        with pytest.raises(err, match="eval_set not supported"):
            make(objective="rank:map").fit(X, y, qid=qid,
                                           eval_set=(X, y))
        m = make(objective="rank:pairwise", n_trees=1, max_depth=2,
                 n_bins=8).fit(X, y, qid=qid)
        with pytest.raises(err, match="continued fit not supported"):
            m.fit(X, y, qid=qid)


# -- 1, 2 and 4 gloo ranks -------------------------------------------------

@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    d = tmp_path_factory.mktemp("rank_dp")
    out = {}
    for nq in (32, 30):
        X, y, qid = _ltr_problem(n_queries=nq, seed=3)
        for a, name in ((X, "X"), (y, "y"), (qid, "qid")):
            np.save(d / f"{name}{nq}.npy", a)
    runs = [{"name": f"{obj}_{nq}", "X": str(d / f"X{nq}.npy"),
             "y": str(d / f"y{nq}.npy"), "qid": str(d / f"qid{nq}.npy"),
             "params": {"objective": obj}}
            for nq in (32, 30) for obj in ("rank:pairwise", "rank:ndcg")]
    for world in (1, 2, 4):
        job = {"backend": "gloo", "device": "cpu", "threads": 1,
               "params": dict(n_trees=3, max_depth=3, n_bins=32),
               "runs": runs, "out": str(d / f"w{world}")}
        launch(job, world=world, timeout=240)
        out[world] = d / f"w{world}"
    return out


@pytest.mark.parametrize("obj", ["rank:pairwise", "rank:ndcg"])
def test_ranks_divisible_query_count_write_one_file(ranked, obj):
    ref = (ranked[1] / f"{obj}_32.0.model").read_bytes()
    for world in (2, 4):
        for r in range(world):
            assert (ranked[world] / f"{obj}_32.{r}.model").read_bytes() \
                == ref, (world, r)


@pytest.mark.parametrize("obj", ["rank:pairwise", "rank:ndcg"])
def test_ranks_padded_query_count(ranked, obj):
    ref = (ranked[1] / f"{obj}_30.0.model").read_bytes()
    assert (ranked[2] / f"{obj}_30.0.model").read_bytes() == ref
    # 4 ranks pad two empty queries: weight 0 leaves the weighted cuts
    # alone, and their rows leave the scale's row-count width alone here
    m1 = HistGBT.load_model(str(ranked[1] / f"{obj}_30.0.model"),
                            device="cpu")
    m4 = HistGBT.load_model(str(ranked[4] / f"{obj}_30.0.model"),
                            device="cpu")
    np.testing.assert_array_equal(m1.cuts.numpy(), m4.cuts.numpy())
    for r in range(4):
        assert (ranked[4] / f"{obj}_30.{r}.model").read_bytes() == ref
    np.testing.assert_array_equal(
        np.load(ranked[4] / f"{obj}_30.margins.npy"),
        np.load(ranked[1] / f"{obj}_30.margins.npy"))
