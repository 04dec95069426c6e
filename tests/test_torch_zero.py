"""The port's ZeRO Adam (``parallel/zero.py``) against the JAX package's, on
the CPU.

4 gloo ranks on a ``data`` axis (and 2 ranks × 2 replicas on
``MeshSpec(data=2, model=2)``), one spawn: replicated parameters whose
sizes the axis does not divide (the flat padding), each rank's own
gradients from numpy seeds, 3 steps.  Held against JAX's ``ZeroAdam`` in
a ``shard_map`` over as many devices with the same per-device gradients:
the parameters after each step on every rank, and each rank's moment
slices, at atol 1e-6 (the same f32 Adam arithmetic; the psum's order may
differ in the last place).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.compat import shard_map  # noqa: E402
from dmlc_core_tpu.parallel.zero import ZeroAdam as JaxZeroAdam  # noqa: E402
from dmlc_core_tpu.parallel.zero import ZeroState as JaxZeroState  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from dmlc_core_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec, create_mesh)
from dmlc_core_tpu_torch.parallel.zero import ZeroAdam  # noqa: E402

torch.set_num_threads(2)

WORLD = 4
TIMEOUT = 180
ATOL = 1e-6
STEPS = 3
SHAPES = {"w": (5, 3), "b": (7,), "e": (2, 2, 2)}
LR = 0.1
#: the data axis's size in each case
CASES = (4, 2)


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, rank):
    rng = np.random.default_rng(100 + 10 * step + rank)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


_RANK = r"""
import os, sys
import numpy as np
import torch
sys.path.insert(0, os.path.dirname(sys.argv[0]))
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dmlc_core_tpu_torch.parallel.zero import ZeroAdam
torch.set_num_threads(1)
coll.init(backend="gloo")
r = coll.rank()
d = sys.argv[1]
z = np.load(os.path.join(d, "zero.npz"))
for n_data in (4, 2):
    mesh = create_mesh(MeshSpec(data=n_data, model=4 // n_data))
    i = mesh.axis_index("data")
    opt = ZeroAdam(lr=float(z["lr"]), mesh=mesh)
    params = {k: torch.from_numpy(z[f"p.{k}"]) for k in ("w", "b", "e")}
    state = opt.init(params)
    out = {}
    for step in range(int(z["steps"])):
        grads = {k: torch.from_numpy(z[f"g.{step}.{i}.{k}"])
                 for k in params}
        params, state = opt.step(params, grads, state)
        for k, v in params.items():
            out[f"p{step}.{k}"] = v.numpy()
    for k in params:
        out[f"mu.{k}"] = state.mu[k].numpy()
        out[f"nu.{k}"] = state.nu[k].numpy()
    np.savez(os.path.join(d, f"d{n_data}.{r}.npz"), data=i, count=state.count,
             **out)
coll.finalize()
"""


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    arrays = {"lr": LR, "steps": STEPS}
    arrays.update({f"p.{k}": v for k, v in _params().items()})
    for step in range(STEPS):
        for r in range(WORLD):
            arrays.update({f"g.{step}.{r}.{k}": v
                           for k, v in _grads(step, r).items()})
    np.savez(d / "zero.npz", **arrays)
    script = d / "rank.py"
    script.write_text(_RANK)
    run_ranks([sys.executable, str(script), str(d)], WORLD, TIMEOUT, d)
    return {n: [dict(np.load(d / f"d{n}.{r}.npz")) for r in range(WORLD)]
            for n in CASES}


def _jax(n_data):
    mesh = JaxMesh(np.asarray(jax.devices()[:n_data]), ("data",))
    opt = JaxZeroAdam(lr=LR)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    spec = {k: P() for k in SHAPES}
    sspec = JaxZeroState(mu=P("data"), nu=P("data"), count=P())
    state = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(spec,),
                              out_specs=sspec, check_vma=False))(params)

    def step(params, grads, state):
        return opt.step(params, {k: g[0] for k, g in grads.items()}, state)

    stepped = jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(spec, {k: P("data") for k in SHAPES}, sspec),
        out_specs=(spec, sspec), check_vma=False))
    history = []
    for s in range(STEPS):
        grads = {k: jnp.stack([_grads(s, r)[k] for r in range(n_data)])
                 for k in SHAPES}
        params, state = stepped(params, grads, state)
        history.append({k: np.asarray(v) for k, v in params.items()})
    return history, state


@pytest.mark.parametrize("n_data", CASES)
def test_parameters_match_jax_every_step(port_runs, n_data):
    history, _ = _jax(n_data)
    for r, got in enumerate(port_runs[n_data]):
        for s, want in enumerate(history):
            for k in SHAPES:
                np.testing.assert_allclose(got[f"p{s}.{k}"], want[k],
                                           rtol=0, atol=ATOL,
                                           err_msg=f"rank {r} step {s} {k}")


@pytest.mark.parametrize("n_data", CASES)
def test_moment_slices_match_jax(port_runs, n_data):
    _, state = _jax(n_data)
    assert int(np.asarray(state.count).reshape(-1)[0]) == STEPS
    for got in port_runs[n_data]:
        i = int(got["data"])
        assert int(got["count"]) == STEPS
        for k, shape in SHAPES.items():
            n = -(-int(np.prod(shape)) // n_data)
            for m in ("mu", "nu"):
                want = np.asarray(getattr(state, m)[k])[i * n:(i + 1) * n]
                np.testing.assert_allclose(got[f"{m}.{k}"], want, rtol=0,
                                           atol=ATOL, err_msg=f"{m} {k}")


def test_one_rank_is_jax_s_one_device_adam():
    """An axis of one (no process group): Adam with JAX's bias
    correction on the whole flat parameter, as JAX's ZeroAdam on one
    device."""
    mesh = create_mesh(MeshSpec(data=1))
    opt = ZeroAdam(lr=LR, mesh=mesh)
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    state = opt.init(params)
    history, _ = _jax(1)
    for s in range(STEPS):
        grads = {k: torch.from_numpy(v) for k, v in _grads(s, 0).items()}
        params, state = opt.step(params, grads, state)
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(), history[s][k],
                                       rtol=0, atol=ATOL)
