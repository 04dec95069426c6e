"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's, on the CPU.

4 gloo ranks, one spawn for every case; JAX on its virtual CPU devices
over ``Mesh(devices.reshape(dp, pp), ("data", "pipe"))`` (port rank ``r``
of ``create_mesh(MeshSpec(data=dp, pipe=pp))`` is JAX device ``r``).

* ``pipeline_apply``: 4 affine stages over ``pipe=4`` against applying
  them in order, and the gradients of a 2-stage pipeline against the
  sequential program's (autograd through the ticks and the ``ppermute``
  Function; the ring-closing psum and the loss boundary's ``1/S``);
* ``PipelineLM`` on ``(data=2, pipe=2)`` and ``(data=1, pipe=4)``: the
  initial weights bit-equal to JAX's, 3 steps' losses and the weights
  after them against JAX's on the same mesh (losses rtol 1e-5, weights
  atol 1e-5: f32 throughout, sums in other orders), and against the
  port's one-rank run;
* ``fit_chunked`` equal to per-step calls; a pipe-split ``save_model``
  file loaded by JAX on one device (bit-equal weights), and JAX's file
  loaded on the port's pipe mesh and trained on.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.compat import shard_map  # noqa: E402
from dmlc_core_tpu.models.checkpoint import gather_tree  # noqa: E402
from dmlc_core_tpu.parallel.pipeline import (  # noqa: E402
    PipelineLM as JaxPipelineLM)
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from dmlc_core_tpu_torch.parallel.pipeline import (  # noqa: E402
    PipelineLM, PipelineLMParam)

torch.set_num_threads(2)

WORLD = 4
TIMEOUT = 240
KW = dict(n_layers=4, d_model=32, n_heads=2, d_ff=64, vocab_size=64,
          max_len=16, n_micro=4)
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
#: (data, pipe) of each PipelineLM case
MESHES = [(2, 2), (1, 4)]


def _data(seed=0, B=8, S=16, V=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, size=(B, S)).astype(np.int64),
            rng.integers(0, V, size=(B, S)).astype(np.int64),
            np.ones((B, S), np.float32))


def _jax_mesh(dp, pp):
    devs = np.asarray(jax.devices()[: dp * pp]).reshape(dp, pp)
    return JaxMesh(devs, ("data", "pipe"))


_RANK = r"""
import json, os, sys
import numpy as np
import torch
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dmlc_core_tpu_torch.parallel.pipeline import PipelineLM, pipeline_apply
torch.set_num_threads(1)
coll.init(backend="gloo")
r = coll.rank()
d = sys.argv[1]
z = np.load(os.path.join(d, "inputs.npz"))
kw = json.loads(str(z["kw"]))
batch = (z["tokens"], z["labels"], z["mask"])
out = {}

# pipeline_apply: 4 affine stages, then the gradients of 2
mesh = create_mesh(MeshSpec(data=1, pipe=4))
W = torch.from_numpy(z["W4"])
s = mesh.axis_index("pipe")
stage = lambda w, h: torch.tanh(h @ w[0])
y = pipeline_apply(stage, W[s:s + 1], torch.from_numpy(z["x4"]), mesh=mesh)
out["apply4"] = y.numpy()
mesh = create_mesh(MeshSpec(data=2, pipe=2))
s = mesh.axis_index("pipe")
w = torch.from_numpy(z["W2"])[s:s + 1].clone().requires_grad_(True)
y = pipeline_apply(stage, w, torch.from_numpy(z["x2"]), mesh=mesh)
loss = coll.psum((y ** 2).sum(), "pipe", mesh) / 2
loss.backward()
out["grad2"] = coll.all_gather(w.grad, "pipe", mesh=mesh).numpy()

for dp, pp in ((2, 2), (1, 4)):
    mesh = create_mesh(MeshSpec(data=dp, pipe=pp))
    m = PipelineLM(mesh=mesh, device="cpu", **kw)
    m.init_params(0)
    init = m.gather_params()
    losses = [m.train_step(*batch) for _ in range(3)]
    out[f"lm{dp}{pp}.losses"] = np.array(losses)
    for k, v in m.gather_params().items():
        out[f"lm{dp}{pp}.p.{k}"] = v
    if (dp, pp) == (2, 2):
        for k, v in init.items():
            out[f"init.{k}"] = v
        m.save_model(os.path.join(d, "port.bin"))
        c = PipelineLM(mesh=mesh, device="cpu", **kw)
        c.init_params(0)
        loss, _, times = c.fit_chunked(*batch, n_steps=2, chunk=1,
                                       warmup_chunks=1)
        out["chunked.loss"] = np.array(loss)
        for k, v in c.gather_params().items():
            out[f"chunked.p.{k}"] = v
        j = PipelineLM.load_model(os.path.join(d, "jax.bin"), mesh=mesh,
                                  device="cpu")
        for k, v in j.gather_params().items():
            out[f"loaded.p.{k}"] = v
        out["loaded.next"] = np.array(j.train_step(*batch))
if r == 0:
    np.savez(os.path.join(d, "port.npz"), **out)
coll.barrier()
coll.finalize()
"""


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """JAX's one-device model after 3 steps: its file, its weights, the
    next step's loss."""
    d = tmp_path_factory.mktemp("jax_plm")
    m = JaxPipelineLM(mesh=_jax_mesh(1, 1), **KW)
    m.init_params(5)
    for _ in range(STEPS):
        m.train_step(*_data())
    path = str(d / "jax.bin")
    m.save_model(path)
    return path, gather_tree(m.params), m.train_step(*_data())


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, jax_file):
    d = tmp_path_factory.mktemp("plm")
    rng = np.random.default_rng(1)
    tokens, labels, mask = _data()
    np.savez(d / "inputs.npz", kw=json.dumps(KW), tokens=tokens,
             labels=labels, mask=mask,
             W4=rng.normal(size=(4, 8, 8)).astype(np.float32) * 0.3,
             x4=rng.normal(size=(3, 2, 8)).astype(np.float32),
             W2=rng.normal(size=(2, 6, 6)).astype(np.float32) * 0.3,
             x2=rng.normal(size=(2, 2, 6)).astype(np.float32))
    os.symlink(jax_file[0], d / "jax.bin")
    script = d / "rank.py"
    script.write_text(_RANK)
    run_ranks([sys.executable, str(script), str(d)], WORLD, TIMEOUT, d)
    return dict(np.load(d / "port.npz")), dict(np.load(d / "inputs.npz")), d


def _tree(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def test_pipeline_apply_equals_the_stages_in_order(port_runs):
    out, inp, _ = port_runs
    want = inp["x4"]
    for s in range(4):
        want = np.tanh(want @ inp["W4"][s])
    np.testing.assert_allclose(out["apply4"], want, rtol=2e-5, atol=2e-6)


def test_pipeline_gradients_equal_the_sequential_program_s(port_runs):
    out, inp, _ = port_runs
    W = torch.from_numpy(inp["W2"]).requires_grad_(True)
    y = torch.from_numpy(inp["x2"])
    for s in range(2):
        y = torch.tanh(y @ W[s])
    (y ** 2).sum().backward()
    np.testing.assert_allclose(out["grad2"], W.grad.numpy(), rtol=1e-4,
                               atol=1e-6)
    # and JAX's pipelined gradients
    mesh = _jax_mesh(1, 2)

    def piped(w_all, xm):
        from dmlc_core_tpu.parallel.pipeline import pipeline_apply

        yy = pipeline_apply(lambda w, h: jnp.tanh(h @ w[0]), w_all, xm,
                            "pipe")
        return lax.psum(jnp.sum(yy ** 2), "pipe") / 2

    gp = jax.jit(shard_map(jax.grad(piped), mesh=mesh,
                           in_specs=(P("pipe"), P()), out_specs=P("pipe"),
                           check_vma=False))(jnp.asarray(inp["W2"]),
                                             jnp.asarray(inp["x2"]))
    np.testing.assert_allclose(out["grad2"], np.asarray(gp), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dp,pp", MESHES)
def test_pipeline_lm_matches_jax_on_the_same_mesh(port_runs, dp, pp):
    out, _, _ = port_runs
    m = JaxPipelineLM(mesh=_jax_mesh(dp, pp), **KW)
    m.init_params(0)
    want = [m.train_step(*_data()) for _ in range(STEPS)]
    np.testing.assert_allclose(out[f"lm{dp}{pp}.losses"], want,
                               rtol=LOSS_RTOL)
    got = _tree(out, f"lm{dp}{pp}.p.")
    for k, v in gather_tree(m.params).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("dp,pp", MESHES)
def test_pipeline_lm_matches_the_port_s_one_rank_run(port_runs, dp, pp):
    out, _, _ = port_runs
    m = PipelineLM(device="cpu", **KW)
    m.init_params(0)
    want = [m.train_step(*_data()) for _ in range(STEPS)]
    np.testing.assert_allclose(out[f"lm{dp}{pp}.losses"], want,
                               rtol=LOSS_RTOL)
    got = _tree(out, f"lm{dp}{pp}.p.")
    for k, v in m.gather_params().items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_initial_weights_bit_equal_jax_s(port_runs):
    out, _, _ = port_runs
    m = JaxPipelineLM(mesh=_jax_mesh(1, 1), **KW)
    m.init_params(0)
    got = _tree(out, "init.")
    want = gather_tree(m.params)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes(), k


def test_fit_chunked_equals_per_step_calls(port_runs):
    out, _, _ = port_runs
    # one warmup chunk of 1 and 2 timed steps: the 3-step run
    assert float(out["chunked.loss"]) == float(out["lm22.losses"][-1])
    lm, ch = _tree(out, "lm22.p."), _tree(out, "chunked.p.")
    for k in lm:
        assert np.array_equal(lm[k], ch[k]), k


def test_pipe_split_file_loads_in_jax(port_runs):
    out, _, d = port_runs
    jm = JaxPipelineLM.load_model(str(d / "port.bin"), mesh=_jax_mesh(1, 1))
    got = gather_tree(jm.params)
    for k, v in _tree(out, "lm22.p.").items():
        assert got[k].tobytes() == v.tobytes(), k


def test_jax_file_loads_on_the_port_s_pipe_mesh(port_runs, jax_file):
    out, _, _ = port_runs
    _, params, next_loss = jax_file
    got = _tree(out, "loaded.p.")
    for k, v in params.items():
        assert got[k].tobytes() == v.tobytes(), k
    np.testing.assert_allclose(float(out["loaded.next"]), next_loss,
                               rtol=LOSS_RTOL)


def test_param_dict_is_jax_s():
    from dmlc_core_tpu.parallel.pipeline import PipelineLMParam as J

    assert PipelineLMParam().to_dict() == J().to_dict()


def test_refuses_layers_the_pipe_does_not_divide():
    from dmlc_core_tpu_torch.parallel.mesh import _NamedMesh

    mesh = _NamedMesh({"data": 1, "model": 1, "pipe": 3, "seq": 1,
                       "expert": 1}, 0, {}, {})
    with pytest.raises(Error, match="n_layers % pipe"):
        PipelineLM(mesh=mesh, device="cpu", **KW)
