"""Sequence-parallel attention in the port (``parallel/ring_attention.py``,
``parallel/ulysses.py``) against the JAX package's, on the CPU.

The port's ranks are 4 processes of a gloo group (one spawn for every
case); JAX runs ``shard_map`` over its virtual CPU devices.  Each case
is f32 ``q/k/v [2, 32, 4, 8]`` and a cotangent ``dO`` from numpy seeds,
the sequence split over a ``seq`` axis of 2 (``MeshSpec(data=2, seq=2)``:
two replicas) or 4; held: each rank's output block and the gradients of
its ``q/k/v`` blocks (autograd through the ``ppermute`` / ``all_to_all``
Functions: the reverse rotations) against JAX's ``jax.vjp`` of the same
``shard_map``, at atol 1e-5 (f32, the same online softmax; the sums run
in other orders), and against the dense oracle.
"""

import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dmlc_core_tpu.base.compat import shard_map  # noqa: E402
from dmlc_core_tpu.parallel.ring_attention import (  # noqa: E402
    reference_attention as jax_reference, ring_attention as jax_ring)
from dmlc_core_tpu.parallel.ulysses import (  # noqa: E402
    ulysses_attention as jax_ulysses)
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from dmlc_core_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec, create_mesh)
from dmlc_core_tpu_torch.parallel.ring_attention import (  # noqa: E402
    reference_attention, ring_attention)
from dmlc_core_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: E402

torch.set_num_threads(2)

WORLD = 4
#: a group of 4 ranks starts in ~5 s on an idle host
TIMEOUT = 180
ATOL = 1e-5
SHAPE = (2, 32, 4, 8)
CASES = [(method, n_seq, causal) for method in ("ring", "ulysses")
         for n_seq in (2, 4) for causal in (False, True)]


def _case_id(case):
    method, n_seq, causal = case
    return f"{method}_seq{n_seq}_{'causal' if causal else 'full'}"


def _inputs(case):
    rng = np.random.default_rng(CASES.index(case))
    return [rng.normal(size=SHAPE).astype(np.float32) for _ in range(4)]


_RANK = r"""
import os, sys
import numpy as np
import torch
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dmlc_core_tpu_torch.parallel.ring_attention import ring_attention
from dmlc_core_tpu_torch.parallel.ulysses import ulysses_attention
torch.set_num_threads(1)
coll.init(backend="gloo")
r = coll.rank()
d = sys.argv[1]
cases = np.load(os.path.join(d, "cases.npz"))
for name in [str(n) for n in cases["names"]]:
    method, n_seq = name.split("_")[0], int(name.split("_")[1][3:])
    causal = name.endswith("causal")
    mesh = create_mesh(MeshSpec(data=4 // n_seq, seq=n_seq))
    i, n = mesh.axis_index("seq"), n_seq
    blk = lambda a: torch.from_numpy(
        np.ascontiguousarray(np.split(a, n, axis=1)[i]))
    q, k, v, do = (blk(cases[f"{name}.{j}"]) for j in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    fn = ring_attention if method == "ring" else ulysses_attention
    out = fn(q, k, v, "seq", causal=causal, mesh=mesh)
    out.backward(do)
    np.savez(os.path.join(d, f"{name}.{r}.npz"), out=out.detach().numpy(),
             dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy(),
             seq=i, data=mesh.axis_index("data"))
coll.finalize()
"""


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case on 4 gloo ranks: ``{case: {"out", "dq", "dk", "dv"}}``
    assembled from the data-replica 0 ranks' blocks."""
    d = tmp_path_factory.mktemp("sp")
    arrays = {"names": np.array([_case_id(c) for c in CASES])}
    for c in CASES:
        for j, a in enumerate(_inputs(c)):
            arrays[f"{_case_id(c)}.{j}"] = a
    np.savez(d / "cases.npz", **arrays)
    script = d / "rank.py"
    script.write_text(_RANK)
    run_ranks([sys.executable, str(script), str(d)], WORLD, TIMEOUT, d)
    out = {}
    for c in CASES:
        name = _case_id(c)
        blocks = {}
        for r in range(WORLD):
            z = np.load(d / f"{name}.{r}.npz")
            if int(z["data"]) == 0:
                blocks[int(z["seq"])] = z
        out[c] = {k: np.concatenate([blocks[i][k] for i in sorted(blocks)],
                                    axis=1)
                  for k in ("out", "dq", "dk", "dv")}
    return out


def _jax(case):
    method, n_seq, causal = case
    q, k, v, do = (jnp.asarray(a) for a in _inputs(case))
    mesh = JaxMesh(np.asarray(jax.devices()[:n_seq]), ("seq",))
    fn = jax_ring if method == "ring" else jax_ulysses
    f = shard_map(partial(fn, axis_name="seq", causal=causal), mesh=mesh,
                  in_specs=(P(None, "seq"),) * 3, out_specs=P(None, "seq"),
                  check_vma=False)
    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    dq, dk, dv = vjp(do)
    return {"out": np.asarray(out), "dq": np.asarray(dq),
            "dk": np.asarray(dk), "dv": np.asarray(dv)}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_output_matches_jax(port_runs, case):
    want = _jax(case)["out"]
    np.testing.assert_allclose(port_runs[case]["out"], want, rtol=0,
                               atol=ATOL)
    q, k, v, _ = _inputs(case)
    dense = np.asarray(jax_reference(q, k, v, causal=case[2]))
    np.testing.assert_allclose(port_runs[case]["out"], dense, rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_input_gradients_match_jax(port_runs, case):
    want = _jax(case)
    for key in ("dq", "dk", "dv"):
        np.testing.assert_allclose(port_runs[case][key], want[key], rtol=0,
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_axis_is_dense_attention(causal):
    """A ``seq`` axis of one (no process group): the ring is one block of
    the online softmax, Ulysses one local attention."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    mesh = create_mesh(MeshSpec(data=1))
    want = reference_attention(q, k, v, causal=causal)
    for fn in (ring_attention, ulysses_attention):
        torch.testing.assert_close(fn(q, k, v, "seq", causal=causal,
                                      mesh=mesh), want, rtol=0, atol=ATOL)


class _Seq4:
    """A mesh stub: a ``seq`` axis of 4 (the check runs before any
    collective)."""

    def axis_size(self, axis):
        return 4

    def axis_index(self, axis):
        return 0


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    x = torch.zeros(1, 16, 6, 8)
    with pytest.raises(ValueError, match="n_heads 6 not divisible by axis 4"):
        ulysses_attention(x, x, x, "seq", mesh=_Seq4())
