"""Port parity of the data-parallel building blocks that need no process
group: the row math of ``parallel/mesh.py``, the tracker topology of
``parallel/collectives.py``, the sync byte model and the int8 sync codes
of ``ops/histogram.py``, the ``DMLC_HIST_BLOCKS`` helpers of
``models/histgbt.py``, the metrics registry, and the cut merge over
several workers' summaries — each against the JAX package.

Tolerances: integer work and elementwise f32 arithmetic are held
bit-equal.  The column totals of the int8 sync (``tot``, and the
correction of ``dequantize_hist_sum``) are f32 sums of 16 cells of
magnitude up to ~30, which XLA and torch add in different orders: a few
ulps of the partial sums (ulp(32) ≈ 4e-6), so atol 1e-4.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base import metrics as jmetrics  # noqa: E402
from dmlc_core_tpu.models import histgbt as jgbt  # noqa: E402
from dmlc_core_tpu.ops import binlayout as jbl  # noqa: E402
from dmlc_core_tpu.ops import histogram as jh  # noqa: E402
from dmlc_core_tpu.ops import quantile as jq  # noqa: E402
from dmlc_core_tpu.parallel import collectives as jcoll  # noqa: E402
from dmlc_core_tpu.parallel import mesh as jmesh  # noqa: E402
from dmlc_core_tpu_torch.base import metrics as tmetrics  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.base.timer import get_time  # noqa: E402
from dmlc_core_tpu_torch.models import histgbt as tgbt  # noqa: E402
from dmlc_core_tpu_torch.ops import binlayout as tbl  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402
from dmlc_core_tpu_torch.ops import quantile as tq  # noqa: E402
from dmlc_core_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from dmlc_core_tpu_torch.parallel import mesh as tmesh  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# row math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 8, 16, 1001])
def test_shard_row_ranges_match_jax(k):
    for n in (0, 1, 2, 7, 8, 9, 63, 64, 65, 1000, 1013, 4097, 10_000_000):
        assert tmesh.shard_row_ranges(n, k) == jmesh.shard_row_ranges(n, k)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_row_shard_layout_matches_jax(ndev):
    jm = jmesh.local_mesh(ndev)
    for n in (0, 1, 7, 8, 9, 1003, 4097):
        for pad in (0, ndev, 2 * ndev, 64):
            assert (tmesh.row_shard_layout(n, ndev, pad)
                    == jmesh.row_shard_layout(n, jm, pad))
    with pytest.raises(Error):
        tmesh.row_shard_layout(10, 8, pad_multiple=12)


def test_mesh_without_a_group_is_one_device():
    m = tmesh.local_mesh()
    assert (m.size, m.rank, m.shape, m.initialized) == (1, 0, {"data": 1},
                                                        False)
    assert m.row_range(1003) == (0, 1003)
    assert tmesh.device_count(m) == 1 == tmesh.device_count(1)
    assert tmesh.local_mesh(1).size == 1
    with pytest.raises(Error):
        tmesh.local_mesh(2)


# ---------------------------------------------------------------------------
# collectives without a group, and the tracker topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", list(range(1, 18)) + [31, 64])
def test_topology_matches_jax(n):
    assert tcoll.get_tree(n) == jcoll.get_tree(n)
    assert (tcoll.find_share_ring(tcoll.get_tree(n)[1])
            == jcoll.find_share_ring(jcoll.get_tree(n)[1]))
    assert tcoll.get_link_map(n) == jcoll.get_link_map(n)


def test_collectives_are_identities_on_one_worker():
    tcoll.init()                    # no DMLC_* env: stays one worker
    assert (tcoll.rank(), tcoll.world_size(), tcoll.is_distributed()) == (
        0, 1, False)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(tcoll.allreduce(x, "max"), x)
    np.testing.assert_array_equal(tcoll.allgather(x), x[None])
    assert tcoll.broadcast({"a": 1}) == {"a": 1}
    tcoll.barrier()
    t = torch.arange(4)
    assert tcoll.device_allreduce(t) is t
    assert tcoll.device_allgather(t) is t
    assert tcoll.device_reduce_scatter(t) is t
    with pytest.raises(Error):
        tcoll.allreduce(x, "median")
    with pytest.raises(Error):
        tcoll.init(backend="mpi")
    tcoll.finalize()


def test_init_needs_a_tracker_for_several_workers():
    with pytest.raises(Error, match="TRACKER_URI"):
        tcoll.init({"DMLC_NUM_WORKER": "2"}, backend="gloo")
    with pytest.raises(Error, match="TASK_ID"):
        tcoll.init({"DMLC_NUM_WORKER": "2", "DMLC_TRACKER_URI": "127.0.0.1",
                    "DMLC_TASK_ID": "2"}, backend="gloo")
    assert tcoll.world_size() == 1


# ---------------------------------------------------------------------------
# the sync byte model and the int8 sync
# ---------------------------------------------------------------------------

def _layouts():
    rng = np.random.default_rng(4)
    n, F, B = 600, 7, 32
    bins = np.zeros((F, n), np.uint8)
    for f in range(F):
        bins[f] = rng.integers(0, 3 if f in (1, 2, 5) else B, n)
    counts = tbl.bin_counts(torch.from_numpy(bins), B)
    lt = tbl.compute_layout(counts, F, B, pack=True)
    lj = jbl.compute_layout(counts, F, B, pack=True)
    assert lt == lj and lt is not None
    return F, B, lt, lj


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("policy,leaves", [("depthwise", 0),
                                           ("lossguide", 0),
                                           ("lossguide", 4),
                                           ("lossguide", 16)])
def test_hist_psum_bytes_match_jax(policy, leaves, quant):
    kw = dict(grow_policy=policy, max_leaves=leaves, quant=quant)
    for depth in range(1, 8):
        for F, B in ((28, 256), (7, 16), (54, 64)):
            assert (th.hist_psum_bytes_per_round(depth, F, B, **kw)
                    == jh.hist_psum_bytes_per_round(depth, F, B, **kw))
    F, B, lt, lj = _layouts()
    for depth in (1, 3, 6):
        assert (th.hist_psum_bytes_per_round(depth, F, B, layout=lt, **kw)
                == jh.hist_psum_bytes_per_round(depth, F, B, layout=lj,
                                                **kw))


def _partials(n_ranks=4, shape=(2, 4, 6, 16), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * 7.0
            for _ in range(n_ranks)]


def test_quantize_and_dequantize_match_jax():
    parts = _partials()
    gmax = np.max([np.max(np.abs(p), axis=-1, keepdims=True) for p in parts],
                  axis=0)
    qs_t, qs_j = np.zeros(parts[0].shape, np.int32), None
    tot_t = np.zeros(gmax.shape, np.float32)
    for p in parts:
        q_t, sc_t, to_t = th.quantize_hist_partial(torch.from_numpy(p),
                                                   torch.from_numpy(gmax))
        q_j, sc_j, to_j = jh.quantize_hist_partial(jnp.asarray(p),
                                                   jnp.asarray(gmax))
        assert q_t.dtype == torch.int8
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
        np.testing.assert_allclose(to_t.numpy(), np.asarray(to_j),
                                   rtol=0, atol=1e-4)
        qs_t += q_t.numpy().astype(np.int32)
        tot_t += to_t.numpy()
    out_t = th.dequantize_hist_sum(torch.from_numpy(qs_t), sc_t,
                                   torch.from_numpy(tot_t)).numpy()
    out_j = np.asarray(jh.dequantize_hist_sum(
        jnp.asarray(qs_t), jnp.asarray(sc_t.numpy()), jnp.asarray(tot_t)))
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    # the JAX package's bounds (tests/test_fused_round.py): exact column
    # totals, cell error at most n_ranks · scale
    np.testing.assert_allclose(out_t.sum(-1, keepdims=True), tot_t,
                               rtol=1e-5, atol=1e-4)
    exact = np.sum(parts, axis=0)
    assert (np.abs(out_t - exact) <= len(parts) * sc_t.numpy() + 1e-5).all()


# ---------------------------------------------------------------------------
# DMLC_HIST_BLOCKS helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["", "0", "1", "3", "8", "9", "64"])
def test_hist_blocks_matches_jax(monkeypatch, value):
    monkeypatch.setenv("DMLC_HIST_BLOCKS", value or "0")
    for size in (1, 2, 4, 8, 16):
        assert tgbt._hist_blocks(size) == jgbt._hist_blocks(size)
    for size in (3, 6):
        if value in ("", "0"):
            assert tgbt._hist_blocks(size) == 0
            continue
        with pytest.raises(Error, match="power-of-two"):
            tgbt._hist_blocks(size)
        with pytest.raises(Exception, match="power-of-two"):
            jgbt._hist_blocks(size)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_tree_fold_matches_jax(k):
    rng = np.random.default_rng(k)
    parts = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(k)]
    out_t = tgbt._tree_fold([torch.from_numpy(p) for p in parts]).numpy()
    out_j = np.asarray(jgbt._tree_fold([jnp.asarray(p) for p in parts]))
    np.testing.assert_array_equal(out_t.view(np.uint32),
                                  out_j.view(np.uint32))


# ---------------------------------------------------------------------------
# metrics and timer
# ---------------------------------------------------------------------------

def _drive(reg):
    c = reg.counter("rows_total", "rows seen", labels=("src",))
    c.inc(3, src="a")
    c.inc(2.5, src="b\n\"q\"")
    c.inc(src="a")
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    reg.counter("plain_total").inc(11)
    return reg


def _strip_ts(snap):
    for m in snap["metrics"].values():
        for s in m["series"]:
            s.pop("ts", None)
    return snap


def test_metrics_registry_matches_jax(tmp_path):
    rt = _drive(tmetrics.MetricsRegistry())
    rj = _drive(jmetrics.MetricsRegistry())
    assert _strip_ts(rt.snapshot()) == _strip_ts(rj.snapshot())
    assert rt.to_prometheus() == rj.to_prometheus()
    with pytest.raises(ValueError):
        rt.counter("depth")                  # declared as a gauge
    with pytest.raises(ValueError):
        rt.counter("rows_total").inc(1, source="a")
    with pytest.raises(ValueError):
        rt.counter("rows_total", labels=("src",)).inc(-1, src="a")
    path = rt.save_json(str(tmp_path / "m" / "snap.json"))
    assert os.path.exists(path)
    rt.reset()
    assert rt.counter("plain_total").value() == 0.0


def test_metrics_switch_and_hist_psum_counter():
    reg = tmetrics.default_registry()
    name = "dmlc_histogram_psum_bytes_total"

    def total():
        m = reg.snapshot()["metrics"].get(name)
        return sum(s["value"] for s in m["series"]) if m else 0.0

    before = total()
    tcoll.record_hist_psum(1234)
    tcoll.record_hist_psum(0)
    assert total() - before == 1234
    tmetrics.set_enabled(False)
    try:
        assert not tmetrics.enabled()
        tcoll.record_hist_psum(99)
        assert total() - before == 1234
    finally:
        tmetrics.set_enabled(True)


def test_timer_is_monotonic_and_times_the_fit():
    a = get_time()
    b = get_time()
    assert b >= a
    X = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    m = tgbt.HistGBT(device="cpu", n_trees=2, max_depth=2, n_bins=8)
    m.fit(X, (X[:, 0] > 0).astype(np.float32))
    assert 0.0 < m.last_tree_times[0] <= m.last_tree_times[1] \
        <= m.last_fit_seconds


# ---------------------------------------------------------------------------
# cuts over several workers' summaries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_compute_cuts_over_gathered_summaries_matches_jax(weighted):
    rng = np.random.default_rng(17)
    n, F, W, n_bins = 900, 4, 3, 16
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[:, 2] = rng.integers(0, 5, n)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted else None
    ranges = tmesh.shard_row_ranges(n, W)
    S = max(8 * n_bins, 64)

    def shard(a, r):
        lo, hi = ranges[r]
        return None if a is None else a[lo:hi]

    sums_t = np.stack([tq.local_summary(
        torch.from_numpy(shard(X, r)),
        None if w is None else torch.from_numpy(shard(w, r)), S).numpy()
        for r in range(W)])
    sums_j = np.stack([np.asarray(jq.local_summary(
        jnp.asarray(shard(X, r)),
        None if w is None else jnp.asarray(shard(w, r)), S))
        for r in range(W)])
    np.testing.assert_array_equal(sums_t, sums_j)
    for r in range(W):
        cuts_t = tq.compute_cuts(
            torch.from_numpy(shard(X, r)), n_bins,
            None if w is None else torch.from_numpy(shard(w, r)),
            allgather_fn=lambda s, r=r: (
                np.testing.assert_array_equal(s, sums_t[r]) or sums_t))
        cuts_j = jq.compute_cuts(shard(X, r), n_bins, shard(w, r),
                                 allgather_fn=lambda s: sums_j)
        np.testing.assert_array_equal(cuts_t.numpy().view(np.uint32),
                                      np.asarray(cuts_j).view(np.uint32))
