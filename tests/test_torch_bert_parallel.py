"""BERT's parallel axes in the port (``models/bert.py`` on
``parallel/mesh.py``'s named mesh) against the JAX package's, on the CPU.

The port's ranks are processes of a gloo group running
``tools/bert_mesh.py`` (one spawn of 8 ranks and one of 4, every run of
a group inside it); JAX runs the same meshes over its 8 virtual CPU
devices (``create_mesh(MeshSpec(...))``; port rank ``r`` is JAX device
``r``).  Every run starts from the same weights (``init_params`` of one
seed, bit-equal in both packages) at ``tests/test_bert_ring.py``'s TINY
widths and takes 3 steps; held at BERT's tolerances — losses rtol 2e-3,
weights atol 1e-3:

* ``(data=4, seq=2)`` ring, Ulysses and the KVStore sync against JAX on
  the same mesh;
* ``(data=2, model=2, seq=2)`` ring and Ulysses against JAX's
  one-device run, and against JAX's run on the same mesh on the first
  step only (its loss comes before any update): JAX writes Megatron's
  *g* as ``lax.psum``, which its ``shard_map(check_vma=False)``
  transposes to a psum, so its split branches' gradients are
  ``model``-size times too large there (ROADMAP C14; the port's *g* is
  the identity backward, as Megatron's is);
* ``(data=2, expert=2)`` Switch-MoE with a partial mask (loose capacity,
  as JAX's parity test has it) and under capacity pressure (the
  shard-local drops are the same in both packages) against JAX on the
  same mesh;
* every run against the port's own one-rank run from the same weights
  (the pressure run excepted: its drops are shard-local by design);
* ``fit_chunked`` on a mesh equal to per-step calls;
* a sharded ``save_model`` file loaded by JAX's ``BERT.load_model`` on
  one device (bit-equal weights and momentum), and JAX's file loaded on
  the port's 8-rank mesh and trained on.

Refusals: the port refuses what JAX refuses, under the same conditions.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.models.bert import BERT as JaxBERT  # noqa: E402
from dmlc_core_tpu.models.checkpoint import gather_tree  # noqa: E402
from dmlc_core_tpu.parallel.mesh import (  # noqa: E402
    MeshSpec as JaxMeshSpec, create_mesh as jax_create_mesh, local_mesh)
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.models import BERT  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from dmlc_core_tpu_torch.parallel.mesh import _NamedMesh  # noqa: E402

torch.set_num_threads(2)

TINY = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab_size=64,
            max_len=32, learning_rate=0.1)
MOE = dict(TINY, max_len=16, ffn_type="moe", n_experts=4,
           capacity_factor=8.0)
STEPS = 3
LOSS_RTOL = 2e-3
PARAM_ATOL = 1e-3
#: a group of 8 ranks starts in ~10 s on an idle host
TIMEOUT = 300

DMS = {"data": 2, "model": 2, "seq": 2}
D4S2 = {"data": 4, "seq": 2}
DE = {"data": 2, "expert": 2}
#: name -> (mesh, BERT keywords over TINY, batch)
RUNS8 = {
    "dms_ring": (DMS, {}, "dense"),
    "dms_ulysses": (DMS, {"sp_method": "ulysses"}, "dense"),
    "d4s2_ring": (D4S2, {}, "dense"),
    "d4s2_ulysses": (D4S2, {"sp_method": "ulysses"}, "dense"),
    "d4s2_kvstore": (D4S2, {"grad_sync": "kvstore"}, "dense"),
}
RUNS4 = {
    "de_moe_partial": (DE, {}, "partial"),
    "de_moe_pressure": (DE, {"capacity_factor": 1.0}, "moe"),
}
SAME_MESH = ("d4s2_ring", "d4s2_ulysses", "d4s2_kvstore", "de_moe_partial",
             "de_moe_pressure")
MODEL_AXIS = ("dms_ring", "dms_ulysses")


def _batch(kind):
    if kind == "dense":
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, 64, size=(4, 32))
        mask = (rng.uniform(size=(4, 32)) < 0.3).astype(np.float32)
        mask[:, 0] = 1.0
        return tokens, tokens.copy(), mask
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(8, 16))
    if kind == "partial":
        # skewed density: the first rows mostly in, the last mostly out
        mask = (rng.random((8, 16)) < np.linspace(0.9, 0.1, 8)[:, None]
                ).astype(np.float32)
    else:
        mask = np.ones((8, 16), np.float32)
    return tokens, tokens.copy(), mask


def _kw(name):
    runs = {**RUNS8, **RUNS4}
    base = MOE if name.startswith("de_") else TINY
    return {**base, **runs[name][1]}


def _jax_model(mesh, kw):
    m = JaxBERT(mesh=mesh, **kw)
    m.init_params(0)
    return m


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return jax_create_mesh(JaxMeshSpec(**shape), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX: each run on its mesh, and each configuration on one device
    (losses, weights), plus the file a one-device run writes after its
    steps and the loss of the step after."""
    d = tmp_path_factory.mktemp("jax_bert")
    out = {}
    for name, (shape, _, kind) in {**RUNS8, **RUNS4}.items():
        m = _jax_model(_jax_mesh(shape), _kw(name))
        b = _batch(kind)
        out[name] = ([m.train_step(*b) for _ in range(STEPS)],
                     gather_tree(m.params))
    for key, kw, kind in (("one_dense", TINY, "dense"),
                          ("one_kvstore", dict(TINY, grad_sync="kvstore"),
                           "dense"),
                          ("one_moe", MOE, "partial")):
        m = _jax_model(local_mesh(1), kw)
        b = _batch(kind)
        out[key] = ([m.train_step(*b) for _ in range(STEPS)],
                    gather_tree(m.params))
        if key == "one_dense":
            path = str(d / "jax_after.bin")
            m.save_model(path)
            out["jax_file"] = path
            out["jax_opt"] = gather_tree(m.opt_state)
            out["jax_next"] = m.train_step(*b)
    return out


def _spawn(d, world, runs, batch_kind, extra=()):
    b = _batch(batch_kind)
    np.savez(d / "batch.npz", tokens=b[0], labels=b[1], mask=b[2])
    job = {"device": "cpu", "threads": 1,
           "batch": str(d / "batch.npz"), "out": str(d),
           "runs": [{"name": n, "mesh": shape, "bert": _kw(n), "seed": 0,
                     "steps": STEPS, "save": True}
                    for n, (shape, _, _) in runs.items()] + list(extra)}
    (d / "job.json").write_text(json.dumps(job))
    run_ranks([sys.executable, "-m", "dmlc_core_tpu_torch.tools.bert_mesh",
               str(d / "job.json")], world, TIMEOUT, d)


def _read(d, name):
    rec = json.loads((d / f"{name}.json").read_text())
    z = np.load(d / f"{name}.npz")
    rec["params"] = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    rec["opt"] = {k[2:]: z[k] for k in z.files if k.startswith("m:")}
    return rec


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, jax_runs):
    """The port: the 8-rank group (the dense meshes, a chunked run, a
    saved file, JAX's file loaded and trained on) and the 4-rank group
    (MoE); ``{name: record with params and opt}``."""
    d8 = tmp_path_factory.mktemp("port8")
    extra = [{"name": "dms_chunked", "mesh": DMS, "bert": TINY, "seed": 0,
              "steps": STEPS, "chunk": 1, "save": True},
             {"name": "dms_saved", "mesh": DMS, "bert": TINY, "seed": 0,
              "steps": STEPS, "save": True,
              "save_model": str(d8 / "port.bin")},
             {"name": "dms_loaded0", "mesh": DMS,
              "load": jax_runs["jax_file"], "steps": 0, "save": True},
             {"name": "dms_loaded", "mesh": DMS, "load": jax_runs["jax_file"],
              "steps": 1, "save": True}]
    _spawn(d8, 8, RUNS8, "dense", extra)
    d4 = tmp_path_factory.mktemp("port4")
    # the two MoE runs take their own batches: one group each
    _spawn(d4, 4, {"de_moe_partial": RUNS4["de_moe_partial"]}, "partial")
    d4b = tmp_path_factory.mktemp("port4b")
    _spawn(d4b, 4, {"de_moe_pressure": RUNS4["de_moe_pressure"]}, "moe")
    out = {n: _read(d8, n) for n in list(RUNS8) + [
        "dms_chunked", "dms_saved", "dms_loaded0", "dms_loaded"]}
    out["de_moe_partial"] = _read(d4, "de_moe_partial")
    out["de_moe_pressure"] = _read(d4b, "de_moe_pressure")
    out["port_file"] = str(d8 / "port.bin")
    return out


def _hold(losses, params, want_losses, want_params):
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert sorted(params) == sorted(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(params[k], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", SAME_MESH)
def test_mesh_run_matches_jax_on_the_same_mesh(port_runs, jax_runs, name):
    got = port_runs[name]
    assert got["world"] == (8 if name in RUNS8 else 4)
    _hold(got["losses"], got["params"], *jax_runs[name])
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", MODEL_AXIS)
def test_model_axis_run_matches_jax_one_device(port_runs, jax_runs, name):
    got = port_runs[name]
    _hold(got["losses"], got["params"], *jax_runs["one_dense"])
    # before any update JAX's mesh run computes the same loss
    np.testing.assert_allclose(got["losses"][0], jax_runs[name][0][0],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", MODEL_AXIS)
def test_c14_jax_s_model_axis_run_leaves_its_one_device_run(jax_runs, name):
    """ROADMAP C14, open in the JAX package: its run on a ``model`` axis
    of 2 parts from its own one-device run by more than BERT's tolerance
    (the split branches' gradients doubled), where the port's does not
    (the test above)."""
    losses, params = jax_runs[name]
    one_losses, one_params = jax_runs["one_dense"]
    off = max(float(np.abs(params[k] - one_params[k]).max())
              for k in one_params)
    assert off > 10 * PARAM_ATOL
    assert abs(losses[-1] - one_losses[-1]) > LOSS_RTOL * abs(one_losses[-1])


def _port_one_rank(kw, kind):
    m = BERT(device="cpu", **kw)
    m.init_params(0)
    b = _batch(kind)
    losses = [m.train_step(*b) for _ in range(STEPS)]
    return losses, {k: v.detach().numpy() for k, v in m.params.items()}


@pytest.mark.parametrize("name", list(RUNS8) + ["de_moe_partial"])
def test_mesh_run_matches_the_port_s_one_rank_run(port_runs, jax_runs, name):
    kind = {**RUNS8, **RUNS4}[name][2]
    want = _port_one_rank(_kw(name), kind)
    got = port_runs[name]
    _hold(got["losses"], got["params"], *want)
    # and the one-rank runs are JAX's one-device ones
    key = ("one_moe" if name.startswith("de_") else "one_kvstore"
           if "kvstore" in name else "one_dense")
    _hold(*want, *jax_runs[key])


def test_fit_chunked_on_a_mesh_equals_per_step_calls(port_runs):
    a, b = port_runs["dms_chunked"], port_runs["dms_ring"]
    assert a["losses"][-1] == b["losses"][-1]
    for k in b["params"]:
        assert np.array_equal(a["params"][k], b["params"][k]), k
        assert np.array_equal(a["opt"][k], b["opt"][k]), k


def test_sharded_file_loads_in_jax(port_runs):
    saved = port_runs["dms_saved"]
    jm = JaxBERT.load_model(port_runs["port_file"], mesh=local_mesh(1))
    got, opt = gather_tree(jm.params), gather_tree(jm.opt_state)
    assert list(got) == list(saved["params"])
    for k, v in saved["params"].items():
        assert got[k].tobytes() == v.tobytes(), k
        assert opt[k].tobytes() == saved["opt"][k].tobytes(), k


def test_jax_file_loads_on_the_port_s_mesh(port_runs, jax_runs):
    # the blocks split over 8 ranks and gathered back: the file's bytes
    loaded0 = port_runs["dms_loaded0"]
    for k, v in jax_runs["one_dense"][1].items():
        assert loaded0["params"][k].tobytes() == v.tobytes(), k
        assert loaded0["opt"][k].tobytes() == jax_runs["jax_opt"][k].tobytes()
    # one step on from JAX's weights and momentum: JAX's next loss
    np.testing.assert_allclose(port_runs["dms_loaded"]["losses"][0],
                               jax_runs["jax_next"], rtol=LOSS_RTOL)


def _stub(**sizes):
    """A mesh of the given axis sizes without a process group (the
    constructor reads only names and sizes)."""
    full = {ax: sizes.get(ax, 1) for ax in ("data", "model", "pipe", "seq",
                                            "expert")}
    return _NamedMesh(full, 0, {}, {})


REFUSALS = {
    "ulysses_heads": (dict(model=2, seq=4),
                      dict(n_layers=1, d_model=24, n_heads=6, d_ff=32,
                           vocab_size=32, max_len=16, sp_method="ulysses"),
                      "n_heads=6"),
    "heads_over_model": (dict(data=2, model=4),
                         dict(n_layers=1, d_model=24, n_heads=6, d_ff=32,
                              vocab_size=32, max_len=16), "n_heads % tp"),
    "d_ff_over_model": (dict(data=2, model=4),
                        dict(n_layers=1, d_model=32, n_heads=4, d_ff=34,
                             vocab_size=32, max_len=16), "d_ff % tp"),
    "experts_over_axis": (dict(data=2, expert=4),
                          dict(MOE, n_experts=6), "n_experts % ep"),
    "moe_kvstore": (dict(data=8), dict(MOE, grad_sync="kvstore"),
                    "grad_sync='fused' only"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refuses_what_jax_refuses(case):
    sizes, kw, match = REFUSALS[case]
    with pytest.raises(JaxError, match=match.replace("'", ".")):
        JaxBERT(mesh=_jax_mesh(sizes), **kw)
    with pytest.raises(Error, match=match.replace("'", ".")):
        BERT(mesh=_stub(**sizes), device="cpu", **kw)


@pytest.mark.parametrize("sizes", [dict(data=2, model=2, seq=2),
                                   dict(data=4, seq=2, expert=1),
                                   dict(data=2, expert=2)])
def test_takes_what_jax_takes(sizes):
    kw = MOE if "expert" in sizes and sizes["expert"] > 1 else TINY
    for sp in ("ring", "ulysses"):
        JaxBERT(mesh=_jax_mesh(sizes), sp_method=sp, **kw)
        BERT(mesh=_stub(**sizes), device="cpu", sp_method=sp, **kw)


def test_a_mesh_without_a_data_axis_is_refused():
    mesh = _NamedMesh({"model": 2}, 0, {}, {})
    with pytest.raises(Error, match="needs a 'data' axis"):
        BERT(mesh=mesh, device="cpu", **TINY)
