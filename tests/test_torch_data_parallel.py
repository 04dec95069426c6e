"""Data-parallel ``HistGBT`` in the port: ranks are processes of a gloo
group on the CPU (``parallel.launch``; they import only the port), each
world size started once, every configuration fitted inside that group.

Contracts held:

* 1, 2 and 4 ranks write the model file of the 1-process fit, byte for
  byte, for depth-wise, lossguide (4 leaves) and lossguide with
  ``DMLC_BIN_PACK``, each with ``DMLC_HIST_BLOCKS`` unset and 8 and with
  ``DMLC_TPU_FUSED_DESCEND`` 0 and 1 (int64 sums do not depend on how the
  rows are split); ``train_margins`` and ``predict`` are equal too;
* against the JAX package on its 8-virtual-device mesh with
  ``DMLC_HIST_BLOCKS=8`` (tests/test_multichip.py's data and ``KW``):
  the same split structure, tree 0 bit-identical (its g/h, 0.5 − y and
  0.25, are order-exact), later leaves allclose at atol 1e-5 — JAX sums
  real gradients in f32 (tests/test_torch_histgbt.py's tolerance);
* the same for NaN-as-missing mode (the unfused chain with a learned
  direction; with ``DMLC_HIST_BLOCKS=8`` and the fused descend requested
  too), and with an eval set and early stopping, whose ``eval_history``
  is the 1-process fit's on every rank;
* the same for ``multi:softmax`` (3 trees a round; depth-wise, with
  ``DMLC_HIST_BLOCKS=8`` and the fused descend, lossguide, missing mode),
  column sampling and monotone constraints; the 2-rank softmax file has
  the split structure of the JAX package's fit on a 2-device mesh;
* ``DMLC_HIST_QUANT`` (int8 code sync) stays within the JAX package's
  bounds of the exact fit (tests/test_fused_round.py: max < 0.15, mean
  < 0.02 margin difference) and is exact on one rank;
* the histogram-sync counter equals its model — twice the f32 model for
  the int64 sync, JAX's quant model under quant — and stays silent on
  one rank (tests/test_multichip.py's traffic tests);
* the collectives and the cut merge over a real 2-rank group.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import launch, run_ranks  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

KW = dict(n_trees=3, max_depth=3, n_bins=16, learning_rate=0.3)
WORLDS = (1, 2, 4)
#: per rank group; a group starts in ~4 s on an idle host
TIMEOUT = 120

LG = {"DMLC_GROW_POLICY": "lossguide", "DMLC_MAX_LEAVES": "4"}
POLICIES = {"depthwise": {}, "lossguide": LG,
            "pack": {**LG, "DMLC_BIN_PACK": "1"}}
CONFIGS = {
    f"{pol}_b{blocks or 0}_f{fuse}": {
        **env, **({"DMLC_HIST_BLOCKS": "8"} if blocks else {}),
        "DMLC_TPU_FUSED_DESCEND": str(fuse)}
    for pol, env in POLICIES.items() for blocks in (0, 8) for fuse in (0, 1)}
CONFIGS["quant"] = {"DMLC_HIST_QUANT": "1"}
# NaN-as-missing mode (the unfused chain on every world size), and an
# eval set with early stopping on NaN data, a score a round
CONFIGS["missing"] = {}
CONFIGS["missing_b8_f1"] = {"DMLC_HIST_BLOCKS": "8",
                            "DMLC_TPU_FUSED_DESCEND": "1"}
CONFIGS["missing_eval"] = {"DMLC_TPU_ROUNDS_PER_DISPATCH": "1"}
# multi:softmax (K trees a round, each class tree's histograms synced),
# column sampling (the same feature mask on every rank; row sampling
# folds the rank into its key, so N ranks draw unlike one) and monotone
# constraints, each over the run's own params
CONFIGS["softmax"] = {}
CONFIGS["softmax_b8_f1"] = {"DMLC_HIST_BLOCKS": "8",
                            "DMLC_TPU_FUSED_DESCEND": "1"}
CONFIGS["softmax_lossguide"] = dict(LG)
CONFIGS["softmax_missing"] = {}
CONFIGS["colsample"] = {}
CONFIGS["monotone"] = {}
SOFTMAX = {"objective": "multi:softmax", "num_class": 3}
RUN_PARAMS = {"softmax": SOFTMAX, "softmax_b8_f1": SOFTMAX,
              "softmax_lossguide": SOFTMAX, "softmax_missing": SOFTMAX,
              "colsample": {"colsample_bytree": 0.6, "seed": 5},
              "monotone": {"monotone_constraints": [1, 0, 1, 0, 0, 0, 0]}}
LEVERS = ("DMLC_GROW_POLICY", "DMLC_MAX_LEAVES", "DMLC_BIN_PACK",
          "DMLC_HIST_BLOCKS", "DMLC_TPU_FUSED_DESCEND", "DMLC_HIST_QUANT",
          "DMLC_FUSED_ROUND", "DMLC_FEATURE_BUNDLE",
          "DMLC_TPU_ROUNDS_PER_DISPATCH")
#: with n_trees 3 no stop comes before the last round
EARLY_STOP = 2


def _make_xy(n, F=6, seed=0):
    """tests/test_multichip.py's data."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * X[:, 2] > 0).astype(np.float32)
    return X, y


def _narrow_xy(n=1003, seed=5):
    """tests/test_multichip.py's packing data: two narrow features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 7)).astype(np.float32)
    X[:, 2] = rng.integers(0, 3, n).astype(np.float32)
    X[:, 5] = rng.integers(0, 4, n).astype(np.float32)
    y = (X[:, 0] + X[:, 2] > 0.5).astype(np.float32)
    return X, y


def _nan_xy(n=1003, seed=2):
    """``_make_xy``'s rows with NaN: 10% of every feature but the first,
    and feature 0 wherever it exceeds 1.0."""
    X, y = _make_xy(n, F=7, seed=seed)
    rng = np.random.default_rng(seed + 100)
    X[:, 1:][rng.random((n, 6)) < 0.1] = np.nan
    X[X[:, 0] > 1.0, 0] = np.nan
    return X, y


def _data_of(name):
    if name == "softmax_missing":
        return "nan_multi"
    if name.startswith("softmax"):
        return "multi"
    if name.startswith("missing"):
        return "nan"
    return "narrow" if name.startswith("pack") else "main"


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Every configuration fitted in-process (no group) and by 1, 2 and
    4 ranks; returns ``(refs, dir)`` with ``refs[name] = (model bytes,
    margins, predictions, bin layout or None)``."""
    d = tmp_path_factory.mktemp("dp")
    data = {"main": _make_xy(1003, F=7, seed=1), "narrow": _narrow_xy(),
            "nan": _nan_xy(), "nan_eval": _nan_xy(401, seed=3)}
    for key in ("main", "nan"):
        X = data[key][0]
        data[f"{key}_multi" if key == "nan" else "multi"] = (
            X, np.digitize(np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(
                X[:, 1]), [-0.5, 0.5]).astype(np.float32))
    for key, (X, y) in data.items():
        np.save(d / f"X_{key}.npy", X)
        np.save(d / f"y_{key}.npy", y)
    runs = [{"name": name, "env": env,
             "X": str(d / f"X_{_data_of(name)}.npy"),
             "y": str(d / f"y_{_data_of(name)}.npy"),
             "Xv": str(d / f"X_{_data_of(name)}.npy"),
             "params": RUN_PARAMS.get(name, {})}
            for name, env in CONFIGS.items()]
    for run in runs:
        if run["name"] == "missing_eval":
            run["eval"] = {"X": str(d / "X_nan_eval.npy"),
                           "y": str(d / "y_nan_eval.npy"),
                           "early_stopping_rounds": EARLY_STOP}
    refs = {}
    saved = {k: os.environ.pop(k, None) for k in LEVERS}
    try:
        for run in runs:
            X, y = data[_data_of(run["name"])]
            os.environ.update(run["env"])
            m = HistGBT(device="cpu", **KW, **run["params"])
            if "eval" in run:
                m.fit(X, y, eval_set=data["nan_eval"],
                      early_stopping_rounds=EARLY_STOP)
                (d / f"{run['name']}.ref.json").write_text(json.dumps({
                    "eval_history": m.eval_history,
                    "best_iteration": m.best_iteration,
                    "best_score": m.best_score}))
            else:
                m.fit(X, y)
            for k in run["env"]:
                del os.environ[k]
            path = d / f"{run['name']}.ref.model"
            m.save_model(str(path))
            refs[run["name"]] = (path.read_bytes(), m.train_margins(),
                                 m.predict(X, output_margin=True),
                                 m._bin_layout)
        for world in WORLDS:
            launch({"backend": "gloo", "device": "cpu", "threads": 1,
                    "params": KW, "runs": runs, "out": str(d / f"w{world}")},
                   world, TIMEOUT)
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    return refs, d


def _stats(d, world, name, rank=0):
    return json.loads((d / f"w{world}" / f"{name}.{rank}.json").read_text())


@pytest.mark.parametrize("name", sorted(set(CONFIGS) - {"quant"}))
def test_world_sizes_write_the_one_process_model(dp, name):
    refs, d = dp
    ref_bytes, ref_margins, ref_pred, layout = refs[name]
    fired = layout is not None
    assert fired == name.startswith("pack")      # the lever fires
    for world in WORLDS:
        w = d / f"w{world}"
        for r in range(world):
            assert (w / f"{name}.{r}.model").read_bytes() == ref_bytes, (
                name, world, r)
        np.testing.assert_array_equal(np.load(w / f"{name}.margins.npy"),
                                      ref_margins)
        np.testing.assert_array_equal(np.load(w / f"{name}.pred.npy"),
                                      ref_pred)
        st = _stats(d, world, name)
        assert st["world"] == world and st["layout"] == fired
        assert st["missing"] == ("missing" in name)
        # kernels count launches on CUDA tensors only
        assert not any(st["launches"].values())


def test_eval_history_is_the_one_process_history_on_every_rank(dp):
    _, d = dp
    ref = json.loads((d / "missing_eval.ref.json").read_text())
    assert [r for r, _ in ref["eval_history"]] == [1, 2, 3]
    for world in WORLDS:
        for r in range(world):
            st = _stats(d, world, "missing_eval", r)
            assert st["eval_history"] == ref["eval_history"], (world, r)
            assert st["best_iteration"] == ref["best_iteration"]
            assert st["best_score"] == ref["best_score"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sync_counter_matches_its_model(dp, name):
    refs, d = dp
    env = CONFIGS[name]
    quant = name == "quant"
    policy = env.get("DMLC_GROW_POLICY", "depthwise")
    layout = refs[name][3]          # the storage shape the sync moves
    model = th.hist_psum_bytes_per_round(
        KW["max_depth"], 7, KW["n_bins"], layout=layout, grow_policy=policy,
        max_leaves=int(env.get("DMLC_MAX_LEAVES", 0)), quant=quant)
    # multi:softmax syncs each of a round's K class trees
    n_class = RUN_PARAMS.get(name, {}).get("num_class", 1)
    expect = KW["n_trees"] * n_class * (model if quant else 2 * model)
    for world in WORLDS:
        for r in range(world):
            got = _stats(d, world, name, r)["hist_sync_bytes"]
            assert got == (0 if world == 1 else expect), (world, r)


def test_one_rank_group_syncs_only_off_the_fused_round(dp):
    _, d = dp
    depth, trees = KW["max_depth"], KW["n_trees"]
    # no blocks: the fused round, no collective at all
    assert _stats(d, 1, "depthwise_b0_f1")["device_allreduces"] == 0
    # blocks: root + one sync per deeper level, per tree
    assert _stats(d, 1, "depthwise_b8_f1")["device_allreduces"] == (
        depth * trees)
    # two ranks add the scales' max per tree
    assert _stats(d, 2, "depthwise_b0_f1")["device_allreduces"] == (
        (depth + 1) * trees)
    assert _stats(d, 2, "lossguide_b0_f0")["device_allreduces"] == (
        (4 + 1) * trees)


def test_quant_fit_is_close_to_exact_and_exact_on_one_rank(dp):
    refs, d = dp
    exact = refs["depthwise_b0_f0"]
    # one rank: the quant sync is off, the exact fit's bytes
    assert (d / "w1" / "quant.0.model").read_bytes() == exact[0]
    for world in (2, 4):
        for r in range(1, world):
            assert ((d / f"w{world}" / f"quant.{r}.model").read_bytes()
                    == (d / f"w{world}" / "quant.0.model").read_bytes())
        p = np.load(d / f"w{world}" / "quant.pred.npy")
        diff = np.abs(p - exact[2])
        assert float(diff.max()) < 0.15 and float(diff.mean()) < 0.02, (
            world, float(diff.max()), float(diff.mean()))


def test_matches_jax_on_eight_virtual_devices(dp, monkeypatch):
    import jax
    from jax.sharding import Mesh

    from dmlc_core_tpu.models import HistGBT as JaxHistGBT
    from dmlc_core_tpu.ops.quantile import compute_cuts

    _, d = dp
    monkeypatch.setenv("DMLC_HIST_BLOCKS", "8")
    X, y = _make_xy(1003, F=7, seed=1)
    cuts = compute_cuts(X, KW["n_bins"])
    devs = np.array(jax.devices())
    jm = JaxHistGBT(mesh=Mesh(devs[:8], ("data",)), **KW)
    jm.fit(X, y, cuts=cuts)
    pm = HistGBT.load_model(str(d / "w4" / "depthwise_b8_f1.3.model"),
                            device="cpu")
    np.testing.assert_array_equal(pm.cuts.numpy().view(np.uint32),
                                  np.asarray(cuts).view(np.uint32))
    for i, (a, b) in enumerate(zip(pm.trees, jm.trees)):
        np.testing.assert_array_equal(a["feat"], b["feat"])
        np.testing.assert_array_equal(a["thr"], b["thr"])
        if i == 0:
            for k in ("gain", "leaf"):
                np.testing.assert_array_equal(
                    a[k].view(np.uint32), np.asarray(b[k]).view(np.uint32))
        else:
            np.testing.assert_allclose(a["leaf"], b["leaf"], atol=1e-5)
    np.testing.assert_allclose(pm.predict(X, output_margin=True),
                               jm.predict(X, output_margin=True), atol=1e-5)


def test_softmax_on_two_ranks_matches_jax_on_two_devices(dp):
    import jax
    from jax.sharding import Mesh

    from dmlc_core_tpu.models import HistGBT as JaxHistGBT

    _, d = dp
    X, _ = _make_xy(1003, F=7, seed=1)
    y = np.load(d / "y_multi.npy")
    devs = np.array(jax.devices())
    jm = JaxHistGBT(mesh=Mesh(devs[:2], ("data",)), **KW, **SOFTMAX)
    jm.fit(X, y)
    pm = HistGBT.load_model(str(d / "w2" / "softmax.1.model"), device="cpu")
    assert len(pm.trees) == len(jm.trees) == KW["n_trees"]
    for i, (a, b) in enumerate(zip(pm.trees, jm.trees)):
        assert a["feat"].shape == (3, KW["max_depth"], 4)
        np.testing.assert_array_equal(a["feat"], b["feat"], err_msg=str(i))
        np.testing.assert_array_equal(a["thr"], b["thr"], err_msg=str(i))
        np.testing.assert_allclose(a["leaf"], b["leaf"], atol=1e-5)
    np.testing.assert_allclose(pm.predict_proba(X), jm.predict_proba(X),
                               atol=1e-5)


_COLLECTIVES = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from dmlc_core_tpu_torch.ops.quantile import compute_cuts
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import local_mesh
coll.init(backend="gloo")
r = coll.rank()
x = np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1)
t = torch.arange(4, dtype=torch.int64) + 10 * r
mesh = local_mesh()
out = {
    "world": coll.world_size(), "distributed": coll.is_distributed(),
    "mesh": [mesh.size, mesh.rank, list(mesh.row_range(1003))],
    "sum": coll.allreduce(x).tolist(),
    "max": coll.allreduce(x, "max").tolist(),
    "bitor": coll.allreduce(np.array([1 << r]), "bitor").tolist(),
    "gather": coll.allgather(x).tolist(),
    "gather_bool": coll.allgather(np.array([r == 0])).tolist(),
    "bcast": coll.broadcast(x, root=1).tolist(),
    "bcast_obj": coll.broadcast({"from": r}, root=0),
    "dev_sum": coll.device_allreduce(t.clone()).tolist(),
    "dev_max": coll.device_allreduce(t.clone(), op="max").tolist(),
    "dev_gather": coll.device_allgather(t).tolist(),
    "dev_rs": coll.device_reduce_scatter(
        torch.arange(4.0) * (r + 1)).tolist(),
}
coll.barrier()
X = np.load(sys.argv[1])
lo, hi = mesh.row_range(len(X))
cuts = compute_cuts(torch.from_numpy(X[lo:hi]), 16,
                    allgather_fn=coll.allgather)
np.save(f"{sys.argv[2]}/cuts{r}.npy", cuts.numpy())
with open(f"{sys.argv[2]}/coll{r}.json", "w") as f:
    json.dump(out, f)
coll.finalize()
"""


def test_collectives_on_a_two_rank_group(tmp_path):
    import jax.numpy as jnp

    from dmlc_core_tpu.ops import quantile as jq
    from dmlc_core_tpu_torch.parallel.mesh import shard_row_ranges

    X, _ = _make_xy(1003, F=5, seed=3)
    np.save(tmp_path / "X.npy", X)
    run_ranks([sys.executable, "-c", _COLLECTIVES, str(tmp_path / "X.npy"),
               str(tmp_path)], 2, TIMEOUT, tmp_path)
    outs = [json.loads((tmp_path / f"coll{r}.json").read_text())
            for r in range(2)]
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for r, o in enumerate(outs):
        assert o["world"] == 2 and o["distributed"]
        assert o["mesh"] == [2, r, list(shard_row_ranges(1003, 2)[r])]
        np.testing.assert_array_equal(o["sum"], 3 * x)
        np.testing.assert_array_equal(o["max"], 2 * x)
        assert o["bitor"] == [3]
        np.testing.assert_array_equal(o["gather"], [x, 2 * x])
        assert o["gather_bool"] == [[True], [False]]
        np.testing.assert_array_equal(o["bcast"], 2 * x)
        assert o["bcast_obj"] == {"from": 0}
        assert o["dev_sum"] == [10, 12, 14, 16]
        assert o["dev_max"] == [10, 11, 12, 13]
        assert o["dev_gather"] == [0, 1, 2, 3, 10, 11, 12, 13]
        assert o["dev_rs"] == ([0.0, 3.0] if r == 0 else [6.0, 9.0])
    # W ranks' summaries merge to the cuts JAX's merge gives
    S = 8 * 16
    sums = np.stack([np.asarray(jq.local_summary(jnp.asarray(X[lo:hi]),
                                                 None, S))
                     for lo, hi in shard_row_ranges(len(X), 2)])
    want = np.asarray(jq.compute_cuts(X[:502], 16,
                                      allgather_fn=lambda s: sums))
    for r in range(2):
        got = np.load(tmp_path / f"cuts{r}.npy")
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
