"""The port's KVStore (``parallel/kvstore.py``) and checkpoints
(``parallel/checkpoint.py``) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_parallel.py``'s ``TestKVStore`` and ``TestCheckpoint``.
The file's imports of the JAX package's mesh, collectives and tracker
become the port's kvstore, checkpoint and mesh modules, and the
``jax.numpy`` constructors of ``TestCheckpoint`` (``arange``, ``zeros``,
``ones``, ``full``) torch's, so the states are trees of tensors (no
assertion changes).  Left out, each for what has no counterpart in the port:

* ``TestKVStore.test_mesh_dist_sync_bucketed_one_collective`` and
  ``test_bucket_cap_splits_collectives``: JAX's in-mesh form (gradients
  with a leading worker dim sharded over one process's devices) — the
  port runs one process per card, and refuses such a gradient
  (:func:`test_in_mesh_form_is_refused`); the bucket count and the cap
  are held on 2 and 4 gloo ranks below instead;
* ``TestCheckpoint.test_sharded_arrays_preserve_sharding``: a JAX array
  sharded over one process's devices (``NamedSharding``), which the port
  does not have; sharded checkpoints (one file a rank) are held on 2
  gloo ranks below.

The port's own checks: ``dist_sync`` on 2 and 4 gloo ranks (subprocesses)
— a bucketed pull, per-key pulls and one-key buckets give the same
bytes, the rank-order sum of the ranks' gradients, with one collective a
dtype bucket, rank 0's init values everywhere and the
``DMLC_KVSTORE_CHECK`` digest on; KVStore recovery snapshots written by
either package restore in the other; ``checkpoint(sharded=True)`` on 2
ranks writes ``uri.shard-K-of-2`` files in the JAX format that round-trip
(and load in the JAX package), and on one rank is the unsharded file.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.parallel import checkpoint as jax_ckpt  # noqa: E402
from dmlc_core_tpu.parallel.kvstore import KVStore as JaxKVStore  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.parallel import checkpoint as ckpt  # noqa: E402
from dmlc_core_tpu_torch.parallel.kvstore import (KVStore,  # noqa: E402
                                                  rank_order_sum)
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_START = "from dmlc_core_tpu.parallel import (\n"
_END = "from jax.sharding import NamedSharding, PartitionSpec as P\n"
_src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "test_parallel.py")).read()
#: the few ``jax.numpy`` constructors ``TestCheckpoint`` calls, as torch
#: tensors (the port's checkpoint leaves)
_JNP = (
    "import torch\n"
    "class jnp:\n"
    "    arange = staticmethod(torch.arange)\n"
    "    zeros = staticmethod(torch.zeros)\n"
    "    ones = staticmethod(torch.ones)\n"
    "    full = staticmethod(lambda n, v: torch.full((n,), v))\n")
_PAR = load_port("test_parallel.py", [
    ("import jax.numpy as jnp\n", _JNP),
    (_src[_src.index(_START):_src.index(_END) + len(_END)],
     "from dmlc_core_tpu.parallel.kvstore import KVStore\n"
     "from dmlc_core_tpu.parallel.checkpoint import (checkpoint,\n"
     "                                               load_checkpoint)\n"
     "from dmlc_core_tpu.parallel.mesh import local_mesh\n")])
export(globals(), _PAR, ["TestKVStore", "TestCheckpoint"], left_out={
    "TestKVStore": ("test_mesh_dist_sync_bucketed_one_collective",
                    "test_bucket_cap_splits_collectives"),
    "TestCheckpoint": ("test_sharded_arrays_preserve_sharding",)})

#: per rank group; a group starts in ~4 s on an idle host
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def test_in_mesh_form_is_refused():
    kv = KVStore("dist_sync", device="cpu")
    kv.init("w", np.zeros(4, np.float32))
    with pytest.raises(Error, match="in-mesh form"):
        kv.push("w", np.ones((2, 4), np.float32))
    with pytest.raises(Error, match="in-mesh form"):
        KVStore("dist_sync", device="cpu", mesh=object())


def test_local_store_lives_on_its_device():
    kv = KVStore("local", learning_rate=0.5, device="cpu")
    kv.init(["a", "b"], [np.ones(3, np.float32), torch.zeros(2)])
    kv.push(["a", "b"], [torch.ones(3), np.full(2, 2.0, np.float32)])
    a, b = kv.pull(["a", "b"])
    assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
    np.testing.assert_array_equal(a.numpy(), np.full(3, 0.5, np.float32))
    np.testing.assert_array_equal(b.numpy(), np.full(2, -1.0, np.float32))
    assert kv.stats["sync_calls"] == 0          # local: nothing to sync


def test_rank_order_sum_is_a_left_fold():
    rng = np.random.default_rng(4)
    parts = rng.normal(size=(4, 1000)).astype(np.float32) * 1e3
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    got = rank_order_sum(torch.from_numpy(parts)).numpy()
    assert got.tobytes() == want.tobytes()
    assert np.add.reduce(parts, axis=0).tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# dist_sync on gloo ranks
# ---------------------------------------------------------------------------

KEYS = [f"k{i}" for i in range(9)] + ["ints", "wide"]
LR = 0.25


def _values(seed):
    rng = np.random.default_rng(seed)
    vals = [rng.normal(size=(3 + i % 4, 1 + i % 3)).astype(np.float32)
            for i in range(9)]
    vals.append(rng.integers(-9, 9, size=5).astype(np.int32))
    vals.append(rng.normal(size=(7,)))                     # float64
    return vals


def _grads(rank):
    rng = np.random.default_rng(100 + rank)
    out = []
    for v in _values(0):
        g = rng.normal(size=v.shape) * 10
        out.append(g.astype(v.dtype) if v.dtype != np.int32
                   else rng.integers(-5, 5, size=v.shape).astype(np.int32))
    return out


_KV_RANK = r"""
import json, os, sys
import numpy as np
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.kvstore import KVStore
coll.init(backend="gloo")
r = coll.rank()
d = sys.argv[1]
data = np.load(os.path.join(d, "kv.npz"))
keys = [str(k) for k in data["keys"]]
lr = float(data["lr"])
vals = [data[f"v{r}_{i}"] for i in range(len(keys))]
grads = [data[f"g{r}_{i}"] for i in range(len(keys))]
out = {}
for mode, cap in (("bucketed", 64 << 20), ("per_key", 64 << 20),
                  ("one_key_buckets", 4)):
    kv = KVStore("dist_sync", learning_rate=lr, device="cpu",
                 bucket_bytes=cap)
    kv.init(keys, vals)                    # rank 0's values must win
    kv.push(keys, grads)
    kv.push(keys[:3], grads[:3])           # a second push accumulates
    if mode == "per_key":
        got = [kv.pull(k) for k in keys]
    else:
        got = kv.pull(keys)
    out[mode] = {"bytes": [v.numpy().tobytes().hex() for v in got],
                 "stats": kv.stats}
# the port's host allreduce of the same gradients
out["host"] = [coll.allreduce(g).tobytes().hex() for g in grads]
with open(os.path.join(d, f"kv{r}.json"), "w") as f:
    json.dump(out, f)
coll.finalize()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_dist_sync_on_gloo_ranks(world, tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_KV_RANK)
    arrays = {"keys": np.array(KEYS), "lr": np.float64(LR)}
    for r in range(world):
        for i, (v, g) in enumerate(zip(_values(r), _grads(r))):
            arrays[f"v{r}_{i}"], arrays[f"g{r}_{i}"] = v, g
    np.savez(tmp_path / "kv.npz", **arrays)
    run_ranks([sys.executable, str(script), str(tmp_path)], world, TIMEOUT,
              tmp_path, env={**os.environ, "DMLC_KVSTORE_CHECK": "1"})
    outs = [json.loads((tmp_path / f"kv{r}.json").read_text())
            for r in range(world)]
    grads = [_grads(r) for r in range(world)]
    init = _values(0)
    want = []
    for i, v in enumerate(init):
        parts = [g[i] + g[i] if i < 3 else g[i] for g in grads]
        total = parts[0]
        for p in parts[1:]:
            total = total + p                     # rank order, left fold
        want.append((torch.from_numpy(v)
                     - LR * torch.from_numpy(total)).numpy().tobytes().hex())
    n_dtypes = 3
    for o in outs:
        assert o["bucketed"]["bytes"] == want
        assert o["per_key"]["bytes"] == want
        assert o["one_key_buckets"]["bytes"] == want
        assert o["bucketed"]["stats"] == {"sync_calls": n_dtypes,
                                          "keys_synced": len(KEYS)}
        assert o["per_key"]["stats"]["sync_calls"] == len(KEYS)
        assert o["one_key_buckets"]["stats"]["sync_calls"] == len(KEYS)
        host = [np.add.reduce(np.stack([g[i] for g in grads]), axis=0)
                .tobytes().hex() for i in range(len(KEYS))]
        assert o["host"] == host


# ---------------------------------------------------------------------------
# recovery snapshots across the packages
# ---------------------------------------------------------------------------

def _drive(kv):
    kv.init(["w", "b"], [np.ones(4, np.float32), np.zeros(2, np.float32)])
    kv.enable_recovery(kv._snap_uri, stride=2)
    for _ in range(4):
        kv.push(["w", "b"], [np.full(4, 0.1, np.float32),
                             np.full(2, 0.2, np.float32)])
        kv.pull(["w", "b"])
    return [np.asarray(x) for x in kv.pull(["w", "b"])]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recovery_snapshots_cross_load(writer, tmp_path):
    uri = str(tmp_path / "kv.ckpt")
    src = (JaxKVStore.create("local", learning_rate=0.5) if writer == "jax"
           else KVStore.create("local", learning_rate=0.5, device="cpu"))
    src._snap_uri = uri
    want = _drive(src)
    dst = (KVStore.create("local", learning_rate=0.5, device="cpu")
           if writer == "jax" else JaxKVStore.create("local",
                                                     learning_rate=0.5))
    dst.init(["w", "b"], [np.ones(4, np.float32), np.zeros(2, np.float32)])
    assert dst.restore_recovery(uri) == 4
    for got, w in zip(dst.pull(["w", "b"]), want):
        assert np.asarray(got).tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# sharded checkpoints
# ---------------------------------------------------------------------------

_SHARD_RANK = r"""
import os, sys
import numpy as np
import torch
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint, load_checkpoint
coll.init(backend="gloo")
r, w = coll.rank(), coll.world_size()
uri = os.path.join(sys.argv[1], "state.ckpt")
state = {"rows": torch.arange(6, dtype=torch.float32) + 10 * r,
         "step": 7, "name": f"rank{r}"}
checkpoint(uri, state, version=3, sharded=True)
like = {"rows": torch.zeros(6), "step": 0, "name": ""}
v, got = load_checkpoint(uri, like, sharded=True)
assert v == 3 and got["step"] == 7 and got["name"] == f"rank{r}"
assert torch.equal(got["rows"], state["rows"])
coll.barrier()
coll.finalize()
"""


def test_sharded_checkpoints_on_two_ranks(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(_SHARD_RANK)
    run_ranks([sys.executable, str(script), str(tmp_path)], 2, TIMEOUT,
              tmp_path)
    for r in range(2):
        path = str(tmp_path / f"state.ckpt.shard-{r}-of-2")
        assert os.path.exists(path) and os.path.exists(path + ".crc")
        like = {"rows": np.zeros(6, np.float32), "step": 0, "name": ""}
        v, got = jax_ckpt.load_checkpoint(path, like)
        assert v == 3 and got["name"] == f"rank{r}"
        np.testing.assert_array_equal(
            np.asarray(got["rows"]), np.arange(6, dtype=np.float32) + 10 * r)
    assert not os.path.exists(tmp_path / "state.ckpt")


def test_sharded_on_one_rank_is_the_unsharded_file(tmp_path):
    state = {"x": torch.arange(4.0), "v": 2}
    ckpt.checkpoint(str(tmp_path / "a.ckpt"), state, version=5, sharded=True)
    ckpt.checkpoint(str(tmp_path / "b.ckpt"), state, version=5)
    assert ((tmp_path / "a.ckpt").read_bytes()
            == (tmp_path / "b.ckpt").read_bytes())
    v, got = ckpt.load_checkpoint(str(tmp_path / "a.ckpt"),
                                  {"x": torch.zeros(4), "v": 0},
                                  sharded=True)
    assert v == 5 and torch.equal(got["x"], state["x"])
