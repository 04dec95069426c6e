"""MXNet-KVStore-shaped API over the port's collectives (PyTorch port).

The counterpart of ``dmlc_core_tpu/parallel/kvstore.py``: the
consumer-facing surface (``init/push/pull``, ``set_updater``) so
KVStore-based training loops port unchanged.

* ``local``: a single-process store; values are tensors on the store's
  device (``device=``, default ``cuda``).
* ``dist_sync``: push accumulates local gradients on the device; pull
  syncs every pending key of the batch in fusion buckets of at most
  ``bucket_bytes`` (grouped by dtype, the caller's order within a
  group), one collective a bucket, then applies the default SGD
  (``value - lr * grad``) or :meth:`KVStore.set_updater`'s function.
  Over a process group a bucket is one ``device_allgather`` of the
  concatenated gradients followed by a fold over the ranks **in rank
  order** on the device — the order of the port's host ``allreduce``
  (and of numpy's ``add.reduce`` over the gathered ranks) — so a
  bucketed pull, per-key pulls, the card and the CPU give the same
  bytes.  NCCL's own ring sum does not promise that order, so it is not
  used.  Under a host transport (``collectives.set_host_transport``) or
  with no process group the bucket goes through the host ``allreduce``.
  ``init`` is one broadcast of the whole key list (rank 0's values win).
* ``dist_async``: the parameter-server processes of ``parallel/ps``
  behind :class:`DistAsyncKVStore` (server-side SGD, pipelined async
  push, bounded-staleness pull); ``create("dist_async")`` reads the
  ``DMLC_ROLE`` env ABI.

JAX's in-mesh form — values pushed with a leading worker dim sharded over
one process's devices, reduced by one jitted ``shard_map`` program
(``_fused_mesh_reducer`` / ``_fused_mesh_updater``) — has no counterpart:
the port runs one process per card, so a worker's gradient is its own
tensor and the workers are the ranks of the process group.  A pushed
gradient with such a leading worker dim is refused.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dmlc_core_tpu_torch.base import knobs as _knobs
from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal
from dmlc_core_tpu_torch.parallel import collectives as coll
from dmlc_core_tpu_torch.parallel.mesh import Mesh
from dmlc_core_tpu_torch.utils.device import resolve_device

__all__ = ["KVStore", "DistAsyncKVStore"]

Key = Union[int, str]


def rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` along dim 0, left to right: the
    reduction order of the port's host ``allreduce``."""
    acc = parts[0].clone()
    for r in range(1, parts.shape[0]):
        acc += parts[r]
    return acc


class KVStore:
    """``KVStore.create("local" | "dist_sync")`` — init/push/pull.

    The optimizer hook (``set_updater``) matches MXNet's contract:
    ``updater(key, grad, value) -> new_value`` on tensors; the default is
    SGD with ``learning_rate`` (so push/pull alone implements dist-SGD).
    ``mesh`` is the data axis the dist_sync pull reduces over (default:
    the process group's); ``axis`` must be ``"data"``.
    """

    def __init__(self, kv_type: str = "local", learning_rate: float = 0.1,
                 mesh: Optional[Mesh] = None, axis: str = "data",
                 bucket_bytes: int = 64 << 20,
                 device: Optional[Union[str, torch.device]] = None):
        CHECK(kv_type in ("local", "dist_sync", "dist_async"),
              f"unknown kvstore type {kv_type!r}")
        CHECK(mesh is None or isinstance(mesh, Mesh),
              "KVStore: mesh must be the port's parallel.mesh.Mesh (the "
              "process group); JAX's in-mesh form (a device mesh of one "
              "process) has no counterpart — one process per card")
        CHECK(axis == "data", "KVStore: the port's mesh has one axis, "
              "'data'")
        self.type = kv_type
        self.device = (resolve_device(device) if kv_type != "dist_async"
                       else None)
        self._mesh = mesh if mesh is not None else Mesh()
        self._store: Dict[Key, torch.Tensor] = {}
        self._pending: Dict[Key, torch.Tensor] = {}
        self._lr = learning_rate
        #: gradient-fusion bucket cap (bytes) per collective
        self._bucket_bytes = bucket_bytes
        #: observability for tests/benches: collective launches vs keys
        self.stats = {"sync_calls": 0, "keys_synced": 0}
        # bounded-staleness recovery: see enable_recovery()
        self._rec_uri: Optional[str] = None
        self._rec_stride = 0
        self._pull_rounds = 0
        self._updater: Callable[[Key, torch.Tensor, torch.Tensor],
                                torch.Tensor] = (
            lambda key, grad, value: value - self._lr * grad)

    @staticmethod
    def create(kv_type: str = "local", **kw: Any) -> "KVStore":
        if kv_type == "dist_async":
            from dmlc_core_tpu_torch.parallel import ps as _ps

            client = kw.pop("client", None)
            if client is None:
                role = str(_knobs.value("DMLC_ROLE"))
                if role != "worker":
                    _ps.run_role(role)     # serves to completion, exits
                client = _ps.run_role("worker")
            return DistAsyncKVStore(client, **kw)
        return KVStore(kv_type, **kw)

    def _tensor(self, v: Any) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.from_numpy(np.array(v)).to(self.device)

    # -- MXNet KVStore surface -------------------------------------------
    def init(self, keys: Union[Key, Sequence[Key]], values: Any) -> None:
        """Register initial values.  In dist_sync mode rank 0's value wins:
        the whole init list rides ONE broadcast (the values
        byte-concatenated and split back)."""
        keys, values = self._normalize(keys, values)
        seen: set = set()
        for k in keys:
            if k in self._store or k in seen:
                log_fatal(f"KVStore.init: key {k!r} already initialized")
            seen.add(k)
        vals = [v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for v in values]
        if self.type == "dist_sync" and vals:
            blob = np.concatenate(
                [np.ascontiguousarray(v).ravel().view(np.uint8)
                 for v in vals]
            ) if any(v.size for v in vals) else np.zeros(0, np.uint8)
            blob = np.asarray(coll.broadcast(blob, root=0))
            off = 0
            for k, v in zip(keys, vals):
                n = v.nbytes
                self._store[k] = self._tensor(np.frombuffer(
                    blob[off:off + n].tobytes(), v.dtype).reshape(v.shape))
                off += n
        else:
            for k, v in zip(keys, vals):
                self._store[k] = self._tensor(v)

    def push(self, keys: Union[Key, Sequence[Key]], grads: Any) -> None:
        """Accumulate gradients (summed over multiple pushes per key)."""
        keys, grads = self._normalize(keys, grads)
        for k, g in zip(keys, grads):
            self._check_key(k)
            g = self._tensor(g)
            value = self._store[k]
            CHECK(not (self.type == "dist_sync" and g.dim() == value.dim() + 1
                       and tuple(g.shape[1:]) == tuple(value.shape)),
                  f"KVStore.push {k!r}: gradient {tuple(g.shape)} carries a "
                  f"leading worker dim over the value {tuple(value.shape)} "
                  "— JAX's in-mesh form, which has no counterpart in the "
                  "port (one process per card: push this rank's gradient)")
            if k in self._pending:
                self._pending[k] = self._pending[k] + g
            else:
                self._pending[k] = g

    def pull(self, keys: Union[Key, Sequence[Key]]
             ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Sync pending gradients (dist_sync: fused buckets across the
        workers), apply the updater, return current value(s).  Workers
        must pull the same key batch in the same order — the contract
        MXNet's dist_sync KVStore imposes."""
        single = not isinstance(keys, (list, tuple))
        key_list: List[Key] = [keys] if single else list(keys)
        for k in key_list:
            self._check_key(k)
        # dedupe while keeping order: a key listed twice syncs once
        pend = list(dict.fromkeys(k for k in key_list
                                  if k in self._pending))
        grads = {k: self._pending.pop(k) for k in pend}
        if self.type == "dist_sync" and grads:
            grads = self._sync_bucketed(grads)
        for k in pend:
            self._store[k] = self._updater(k, grads[k], self._store[k])
        if pend:
            self._pull_rounds += 1
            if (self._rec_uri and self._rec_stride
                    and self._pull_rounds % self._rec_stride == 0):
                self._snapshot()
        out = [self._store[k] for k in key_list]
        return out[0] if single else out

    # -- bounded-staleness recovery --------------------------------------
    def enable_recovery(self, uri: str, stride: Optional[int] = None) -> None:
        """Round-versioned store snapshots every ``stride`` gradient-
        applying pulls (default ``DMLC_RECOVERY_STRIDE``), through the
        atomic CRC'd checkpoint writer; only rank 0 writes, with no
        barrier (``local``), so a dying peer never wedges a snapshot."""
        if stride is None:
            stride = int(_knobs.value("DMLC_RECOVERY_STRIDE"))
        CHECK(stride >= 1, f"recovery stride must be >= 1, got {stride}")
        self._rec_uri = uri
        self._rec_stride = stride

    def _snapshot(self) -> None:
        from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint

        if coll.rank() == 0:
            state = {str(k): v.detach().cpu().numpy()
                     for k, v in self._store.items()}
            checkpoint(self._rec_uri, state, version=self._pull_rounds,
                       local=True)

    def restore_recovery(self, uri: Optional[str] = None) -> int:
        """Load the newest snapshot into the store (keys must already be
        :meth:`init`-ed); returns its pull-round version, 0 when none."""
        from dmlc_core_tpu_torch.parallel.checkpoint import load_checkpoint

        uri = uri or self._rec_uri
        CHECK(uri is not None, "restore_recovery: no snapshot URI")
        like = {str(k): v for k, v in self._store.items()}
        version, state = load_checkpoint(uri, like)
        if version:
            by_name = {str(k): k for k in self._store}
            for name, value in state.items():
                self._store[by_name[name]] = value
            self._pull_rounds = int(version)
        return int(version)

    # -- the dist_sync reduction -------------------------------------------
    def _check_batch(self, grads: Dict[Key, torch.Tensor]) -> None:
        """``DMLC_KVSTORE_CHECK=1``: every worker must pull the identical
        (key, shape, dtype) batch — a skewed batch would concatenate
        mismatched buckets; two tiny collectives, fail-fast."""
        sig = repr([(str(k), tuple(grads[k].shape), str(grads[k].dtype))
                    for k in grads])
        h = np.array([int.from_bytes(
            hashlib.sha1(sig.encode()).digest()[:8], "big") >> 1], np.int64)
        if coll.allreduce(h, "min")[0] != coll.allreduce(h, "max")[0]:
            log_fatal(
                "KVStore dist_sync: workers pulled DIFFERENT key "
                f"batches (rank {coll.rank()} batch signature differs); "
                "fused bucketing requires identical pull order on "
                f"every worker. Local batch: {sig[:500]}")

    def _reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """One bucket's sum over the workers, in rank order."""
        if coll.get_host_transport() is not None or not coll._initialized():
            host = coll.allreduce(flat.detach().cpu().numpy(), "sum")
            return torch.from_numpy(np.ascontiguousarray(host)).to(
                flat.device)
        gathered = coll.device_allgather(flat, self._mesh)
        return rank_order_sum(gathered.view(-1, flat.numel()))

    def _sync_bucketed(self, grads: Dict[Key, torch.Tensor]
                       ) -> Dict[Key, torch.Tensor]:
        """Allreduce pending grads in fused buckets; returns synced grads
        (the identity with no worker to sync with)."""
        world = coll.world_size()
        if world <= 1 and not self._mesh.initialized:
            return grads
        if world > 1 and int(_knobs.value("DMLC_KVSTORE_CHECK")):
            self._check_batch(grads)
        out: Dict[Key, torch.Tensor] = {}
        for bucket in self._fusion_buckets(grads):
            self.stats["sync_calls"] += 1
            self.stats["keys_synced"] += len(bucket)
            flat = [grads[k].reshape(-1) for k in bucket]
            red = self._reduce(torch.cat(flat) if len(flat) > 1
                               else flat[0].clone())
            off = 0
            for k, f in zip(bucket, flat):
                out[k] = red[off:off + f.numel()].reshape(grads[k].shape)
                off += f.numel()
        return out

    def _fusion_buckets(self, grads: Dict[Key, torch.Tensor]
                        ) -> List[List[Key]]:
        """Dtype-homogeneous fusion buckets of at most ``bucket_bytes``,
        the caller's batch order kept within each dtype group."""
        buckets: List[List[Key]] = []
        by_dtype: Dict[Any, List[Key]] = {}
        for k in grads:
            by_dtype.setdefault(grads[k].dtype, []).append(k)
        for kg in by_dtype.values():
            bucket: List[Key] = []
            size = 0
            for k in kg:
                nbytes = grads[k].numel() * grads[k].element_size()
                if bucket and size + nbytes > self._bucket_bytes:
                    buckets.append(bucket)
                    bucket, size = [], 0
                bucket.append(k)
                size += nbytes
            if bucket:
                buckets.append(bucket)
        return buckets

    def set_updater(self, updater: Callable[[Key, torch.Tensor,
                                             torch.Tensor], torch.Tensor]
                    ) -> None:
        self._updater = updater

    @property
    def rank(self) -> int:
        return coll.rank()

    @property
    def num_workers(self) -> int:
        return coll.world_size()

    # -- helpers ---------------------------------------------------------
    def _check_key(self, k: Key) -> None:
        if k not in self._store:
            log_fatal(f"KVStore: key {k!r} not initialized")

    @staticmethod
    def _normalize(keys, values):
        if isinstance(keys, (list, tuple)):
            CHECK(isinstance(values, (list, tuple))
                  and len(keys) == len(values),
                  "KVStore: keys/values length mismatch")
            return list(keys), list(values)
        return [keys], [values]


class DistAsyncKVStore(KVStore):
    """The KVStore surface over real parameter-server shards.

    Construct through ``KVStore.create("dist_async")`` (worker role).
    Each key's value is range-sharded on dim 0 across the server fleet;
    push sends this worker's gradient asynchronously (server-side SGD on
    arrival) and advances the worker's clock; pull gathers the current
    weights under the bounded-staleness window.  The sparse surface
    (``init_sparse/push_sparse/pull_sparse``) moves only the touched
    ids.  The server applies SGD with this store's ``learning_rate``;
    ``set_updater`` is a hard error.  ``pull`` returns tensors on
    ``device`` (default ``cuda``) — the weights themselves live on the
    host servers — and ``pull_sparse`` numpy arrays, as the JAX store.
    """

    def __init__(self, client: Any, learning_rate: float = 0.1,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__("dist_async", learning_rate=learning_rate)
        self._ps = client
        self._shapes: Dict[Key, tuple] = {}
        self._device_arg = device

    @staticmethod
    def _name(k: Key) -> str:
        return f"kv:{k}"

    def _check_key(self, k: Key) -> None:
        if k not in self._shapes:
            log_fatal(f"KVStore: key {k!r} not initialized")

    def init(self, keys: Union[Key, Sequence[Key]], values: Any) -> None:
        """Declare dense keys on the server fleet (idempotent across
        workers: the first worker's value wins)."""
        keys, values = self._normalize(keys, values)
        for k, v in zip(keys, values):
            if k in self._shapes:
                log_fatal(f"KVStore.init: key {k!r} already initialized")
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            v = np.atleast_1d(np.asarray(v))
            self._ps.init(self._name(k), n_keys=v.shape[0],
                          width=v.shape[1:], dtype=v.dtype,
                          lr=self._lr, value=v)
            self._shapes[k] = v.shape

    def init_sparse(self, key: Key, n_keys: int, width: Sequence[int] = (),
                    dtype: Any = np.float32, init_scale: float = 0.0,
                    seed: int = 0) -> None:
        """Declare a sparse (10M+-cardinality) key on the fleet — no
        value ships; ``init_scale`` > 0 draws each server's slice
        ~ Normal(0, init_scale) seeded by the key range."""
        if key in self._shapes:
            log_fatal(f"KVStore.init: key {key!r} already initialized")
        self._ps.init(self._name(key), n_keys=n_keys, width=width,
                      dtype=dtype, lr=self._lr, init_scale=init_scale,
                      seed=seed)
        self._shapes[key] = (n_keys,) + tuple(int(w) for w in width)

    def push(self, keys: Union[Key, Sequence[Key]], grads: Any) -> None:
        """Async push of whole-key gradients, then advance this worker's
        clock — one dense push call is one committed SSP round."""
        keys, grads = self._normalize(keys, grads)
        for k, g in zip(keys, grads):
            self._check_key(k)
            if isinstance(g, torch.Tensor):
                g = g.detach().cpu().numpy()
            g = np.atleast_1d(np.asarray(g))
            ids = np.arange(self._shapes[k][0], dtype=np.int64)
            self._ps.push(self._name(k), ids, g.reshape(self._shapes[k]))
            self.stats["keys_synced"] += 1
        self._ps.tick()

    def push_sparse(self, key: Key, ids: np.ndarray,
                    grads: np.ndarray) -> None:
        """Async push for the touched ids only (the caller ticks)."""
        self._check_key(key)
        self._ps.push(self._name(key), ids, grads)
        self.stats["keys_synced"] += len(ids)

    def pull(self, keys: Union[Key, Sequence[Key]]
             ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Gather current whole-key weights (staleness-gated)."""
        single = not isinstance(keys, (list, tuple))
        key_list: List[Key] = [keys] if single else list(keys)
        dev = resolve_device(self._device_arg)
        out = []
        for k in key_list:
            self._check_key(k)
            ids = np.arange(self._shapes[k][0], dtype=np.int64)
            v = self._ps.pull(self._name(k), ids)
            out.append(torch.from_numpy(np.array(
                v.reshape(self._shapes[k]))).to(dev))
            self.stats["sync_calls"] += 1
        return out[0] if single else out

    def pull_sparse(self, key: Key, ids: np.ndarray) -> np.ndarray:
        """Current values for the touched ids only (staleness-gated)."""
        self._check_key(key)
        return self._ps.pull(self._name(key), ids)

    def tick(self) -> None:
        """Commit one SSP round (once per minibatch after its pushes)."""
        self._ps.tick()

    def flush(self) -> None:
        """Drain async pushes (all acked server-side)."""
        self._ps.flush()

    def set_updater(self, updater: Callable[..., Any]) -> None:
        log_fatal("dist_async runs the optimizer server-side (SGD with "
                  "the store's learning_rate); custom updaters are a "
                  "dist_sync/local feature")

    def enable_recovery(self, uri: str, stride: Optional[int] = None) -> None:
        log_fatal("dist_async durability is server-side: set "
                  "DMLC_PS_SNAPSHOT_DIR / DMLC_PS_SNAPSHOT_STRIDE on "
                  "the server processes")

    @property
    def rank(self) -> int:
        return self._ps.rank

    @property
    def num_workers(self) -> int:
        return getattr(self._ps, "nworker", 1)

    @property
    def staleness_samples(self) -> List[int]:
        return self._ps.staleness_samples

    def close(self, shutdown_job: bool = True) -> None:
        """Say bye to the fleet (servers exit once every worker did)."""
        self._ps.close(shutdown_job=shutdown_job)
