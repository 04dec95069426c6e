"""The port's Switch-MoE FFN (``parallel/moe.py``) against the JAX
package's, on the CPU.

* Sharded: 4 gloo ranks (one spawn for every case), the experts split
  over an ``expert`` axis of 2 or 4 (``MeshSpec(data=4/ep, expert=ep)``)
  and the 32 tokens too (each rank routes its own block, as BERT's
  data×expert batch does); held against JAX's ``moe_ffn`` in a
  ``shard_map`` over the same split: the output, the routing statistics'
  sums (``stats=True``), and the gradients of a fixed linear loss
  (``sum(y · ct)``) for the tokens, the rank's experts and the router
  (psummed over the ranks, as BERT's step does), with loose capacity and
  under capacity pressure (the shard-local cumsum drops the same tokens
  in both packages).  atol 1e-5 (f32; sums in other orders).
* Unsharded (``axis=None``): against JAX's and against the numpy oracle
  ``reference_moe_ffn`` (the port's copy), drops included.
* Router ties go to the lowest expert, as ``jnp.argmax`` breaks them.
"""

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
from dmlc_core_tpu.parallel.moe import moe_ffn as jax_moe  # noqa: E402
from dmlc_core_tpu.parallel.moe import (  # noqa: E402
    reference_moe_ffn as jax_reference)
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from dmlc_core_tpu_torch.parallel.moe import (  # noqa: E402
    moe_ffn, reference_moe_ffn, top1)

torch.set_num_threads(2)

WORLD = 4
TIMEOUT = 180
ATOL = 1e-5
T, D, F, E = 32, 8, 16, 8
#: (expert axis size, capacity factor): loose, and under pressure
CASES = [(2, 100.0), (4, 100.0), (2, 0.5), (4, 1.0)]
KEYS = ("y", "a_sum", "p_sum", "dx", "dwr", "dw1", "db1", "dw2", "db2")


def _case_id(case):
    return f"ep{case[0]}_cf{case[1]:g}"


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, D)).astype(np.float32)
    ws = (rng.normal(size=(D, E)).astype(np.float32) * 0.5,
          rng.normal(size=(E, D, F)).astype(np.float32) * 0.2,
          rng.normal(size=(E, F)).astype(np.float32) * 0.1,
          rng.normal(size=(E, F, D)).astype(np.float32) * 0.2,
          rng.normal(size=(E, D)).astype(np.float32) * 0.1)
    ct = rng.normal(size=(T, D)).astype(np.float32)
    return x, ws, ct


_RANK = r"""
import os, sys
import numpy as np
import torch
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dmlc_core_tpu_torch.parallel.moe import moe_ffn
torch.set_num_threads(1)
coll.init(backend="gloo")
r = coll.rank()
d = sys.argv[1]
z = np.load(os.path.join(d, "cases.npz"))
for name in [str(n) for n in z["names"]]:
    ep, cf = int(z[name + ".ep"]), float(z[name + ".cf"])
    mesh = create_mesh(MeshSpec(data=4 // ep, expert=ep))
    i = mesh.axis_index("expert")
    blk = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.split(a, ep, axis=0)[i])).requires_grad_(True)
    x = blk(z[name + ".x"])
    wr = torch.from_numpy(z[name + ".wr"]).requires_grad_(True)
    w1, b1, w2, b2 = (blk(z[f"{name}.{k}"]) for k in ("w1", "b1", "w2", "b2"))
    ct = np.split(z[name + ".ct"], ep, axis=0)[i]
    y, (a_sum, p_sum, t) = moe_ffn(x, wr, w1, b1, w2, b2, "expert", cf,
                                   stats=True, mesh=mesh)
    (y * torch.from_numpy(ct)).sum().backward()
    dwr = coll.psum(wr.grad, "expert", mesh)
    a_sum = coll.psum(a_sum, "expert", mesh)
    p_sum = coll.psum(p_sum.detach(), "expert", mesh)
    np.savez(os.path.join(d, f"{name}.{r}.npz"), y=y.detach().numpy(),
             a_sum=a_sum.numpy(), p_sum=p_sum.numpy(), dx=x.grad.numpy(),
             dwr=dwr.numpy(), dw1=w1.grad.numpy(), db1=b1.grad.numpy(),
             dw2=w2.grad.numpy(), db2=b2.grad.numpy(), t=float(t),
             expert=i, data=mesh.axis_index("data"))
coll.finalize()
"""


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case on 4 gloo ranks; ``{case: {key: array}}`` with the
    token- and expert-split arrays assembled in expert-axis order from
    the data-replica 0 ranks."""
    d = tmp_path_factory.mktemp("moe")
    arrays = {"names": np.array([_case_id(c) for c in CASES])}
    for n, c in enumerate(CASES):
        x, ws, ct = _inputs(n)
        name = _case_id(c)
        arrays.update({f"{name}.ep": c[0], f"{name}.cf": c[1],
                       f"{name}.x": x, f"{name}.ct": ct})
        for k, w in zip(("wr", "w1", "b1", "w2", "b2"), ws):
            arrays[f"{name}.{k}"] = w
    np.savez(d / "cases.npz", **arrays)
    script = d / "rank.py"
    script.write_text(_RANK)
    run_ranks([sys.executable, str(script), str(d)], WORLD, TIMEOUT, d)
    out = {}
    for c in CASES:
        blocks = {}
        for r in range(WORLD):
            z = np.load(d / f"{_case_id(c)}.{r}.npz")
            if int(z["data"]) == 0:
                blocks[int(z["expert"])] = z
        order = [blocks[i] for i in sorted(blocks)]
        out[c] = {k: (order[0][k] if k in ("a_sum", "p_sum", "dwr")
                      else np.concatenate([b[k] for b in order]))
                  for k in KEYS}
        out[c]["t"] = [float(b["t"]) for b in order]
    return out


def _jax(case):
    ep, cf = case
    x, ws, ct = _inputs(CASES.index(case))
    mesh = JaxMesh(np.asarray(jax.devices()[:ep]), ("expert",))

    def fn(x, wr, w1, b1, w2, b2, ct):
        def loss(x, wr, w1, b1, w2, b2):
            y, st = jax_moe(x, wr, w1, b1, w2, b2, "expert", cf, stats=True)
            return jnp.sum(y * ct), (y, st)

        (_, (y, (a, p, _))), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
            x, wr, w1, b1, w2, b2)
        return (y, lax.psum(a, "expert"), lax.psum(p, "expert"), g[0],
                lax.psum(g[1], "expert"), *g[2:])

    sh = P("expert")
    outs = jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(sh, P(), sh, sh, sh, sh, sh),
        out_specs=(sh, P(), P(), sh, P(), sh, sh, sh, sh),
        check_vma=False))(*(jnp.asarray(a) for a in (x, *ws, ct)))
    return dict(zip(KEYS, (np.asarray(o) for o in outs)))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_output_and_stats_match_jax(port_runs, case):
    got, want = port_runs[case], _jax(case)
    for k in ("y", "a_sum", "p_sum"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    assert got["t"] == [T / case[0]] * case[0]
    if case[1] < 2:           # capacity pressure: tokens were dropped
        assert (np.abs(got["y"]).max(axis=1) == 0).any()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sharded_gradients_match_jax(port_runs, case):
    got, want = port_runs[case], _jax(case)
    for k in ("dx", "dwr", "dw1", "db1", "dw2", "db2"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > 2],
                         ids=_case_id)
def test_sharded_loose_capacity_is_the_oracle(port_runs, case):
    x, ws, _ = _inputs(CASES.index(case))
    np.testing.assert_allclose(port_runs[case]["y"],
                               reference_moe_ffn(x, *ws), rtol=2e-4,
                               atol=ATOL)


@pytest.mark.parametrize("cf", [100.0, 1.0, 0.5])
def test_unsharded_matches_jax_and_the_oracle(cf):
    x, ws, _ = _inputs(7)
    y, aux = moe_ffn(torch.from_numpy(x), *(torch.from_numpy(w) for w in ws),
                     axis=None, capacity_factor=cf)
    jy, jaux = jax_moe(jnp.asarray(x), *(jnp.asarray(w) for w in ws),
                       axis=None, capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    want = reference_moe_ffn(x, *ws, capacity_factor=cf)
    np.testing.assert_array_equal(want, jax_reference(x, *ws,
                                                      capacity_factor=cf))
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=ATOL)


def test_capacity_drops_to_zero():
    # every token routed to expert 0: cap = ceil(0.5 · 16 / 4) = 2 slots
    x, ws, _ = _inputs(3)
    x = np.abs(x[:16, :4])
    wr = np.zeros((4, 4), np.float32)
    wr[:, 0] = 1.0
    w1, b1, w2, b2 = (w[:4, :4] if w.ndim == 2 else w[:4, :4, :4]
                      for w in ws[1:])
    y, _ = moe_ffn(*(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (x, wr, w1, b1, w2, b2)),
                   axis=None, capacity_factor=0.5)
    assert torch.all(y[2:] == 0) and torch.any(y[:2] != 0)


def test_router_ties_go_to_the_lowest_expert():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                          [0.2, 0.2, 0.3, 0.3], [0.5, 0.1, 0.1, 0.3]])
    want = np.asarray(jnp.argmax(jnp.asarray(probs.numpy()), axis=-1))
    assert top1(probs).tolist() == want.tolist() == [0, 1, 2, 0]
