"""Rabit-shaped collectives over ``torch.distributed``.

The counterpart of ``dmlc_core_tpu/parallel/collectives.py``: the
worker-side rabit API (``Allreduce<op>``, ``Broadcast``,
``rank``/``world_size``) and the tracker's topology math
(``get_tree`` / ``find_share_ring`` / ``get_link_map``).

* **Bootstrap.**  :func:`init` reads the reference's ``DMLC_*`` env ABI
  (``DMLC_NUM_WORKER``, ``DMLC_TRACKER_URI``, ``DMLC_TRACKER_PORT``,
  ``DMLC_TASK_ID``) and joins ``torch.distributed.init_process_group``
  at ``tcp://URI:PORT``: one process per GPU, rank = task id.  The
  backend is ``nccl`` unless the caller asks for ``gloo`` (CPU tensors,
  or several ranks sharing one card, which NCCL refuses); it is never
  chosen from what happens to be installed.
* **Device collectives** (``device_allreduce`` / ``device_allgather`` /
  ``device_reduce_scatter``) act on tensors where they lie — the
  histogram sync of the training loop.  Under gloo a CUDA tensor is
  accepted by ``all_reduce`` and ``broadcast`` only, so the gather and
  the scatter go through host memory there.
* **Host collectives** (``allreduce`` / ``broadcast`` / ``allgather`` /
  ``barrier``) take numpy values between steps.  ``allreduce`` is an
  allgather plus a reduction in rank order on every rank, as in the JAX
  package, so every op is supported and every rank gets the same bits.

Without a process group every collective is the identity on one worker,
so the same program runs on one GPU or many.

* **Host transport** (``set_host_transport``, thread-local as in the JAX
  package): the elastic recovery layer (``parallel.recovery``) runs the
  collectives over the tracker's TCP protocol instead of a process
  group.  An installed transport overrides ``rank``/``world_size`` and
  every host collective; the device collectives become host round trips
  through it (the tensor to numpy, the transport's deterministic
  reduction, the result back onto the tensor's own device), and
  :class:`~dmlc_core_tpu_torch.parallel.mesh.Mesh` takes its size and
  rank from it.  Threads of one process, each with its own transport,
  are workers of one job.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG, log_fatal

__all__ = [
    "init", "finalize", "rank", "world_size", "is_distributed",
    "allreduce", "broadcast", "allgather", "barrier",
    "device_allreduce", "device_allgather", "device_reduce_scatter",
    "allreduce_device", "record_hist_psum", "set_host_transport",
    "get_host_transport", "get_tree", "find_share_ring", "get_link_map",
]

BACKENDS = ("nccl", "gloo")

_REDUCERS = {
    "sum": np.add.reduce,
    "max": np.maximum.reduce,
    "min": np.minimum.reduce,
    "prod": np.multiply.reduce,
    "bitor": np.bitwise_or.reduce,
}


def _dist():
    import torch.distributed as dist

    return dist


_HOST_TRANSPORT = threading.local()


def set_host_transport(transport: Optional[Any]) -> None:
    """Install (``None`` clears) this thread's host-collective transport.

    A transport duck-types ``rank``/``world`` attributes and
    ``allreduce(np_array, op)`` / ``allgather(np_array)`` /
    ``broadcast(value, root)`` / ``barrier(name)`` methods — see
    ``parallel.recovery.ElasticSession``."""
    _HOST_TRANSPORT.t = transport


def get_host_transport() -> Optional[Any]:
    """The transport installed on this thread (None: the process group,
    or one worker)."""
    return getattr(_HOST_TRANSPORT, "t", None)


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


_CM = None


def _coll_metrics():
    global _CM
    if _CM is None:
        r = _metrics.default_registry()
        _CM = {
            "calls": r.counter("collective_calls_total",
                               "collective invocations", labels=("op",)),
            "bytes": r.counter("collective_bytes_total",
                               "payload bytes entering collectives",
                               labels=("op",)),
            "hist_psum": r.counter(
                "histogram_psum_bytes_total",
                "per-rank bytes contributed to the histogram-sync "
                "allreduces of training (the bytes the sync moves)",
                labels=("engine",)),
        }
    return _CM


def _count(op: str, nbytes: int) -> None:
    if _metrics.enabled():
        m = _coll_metrics()
        m["calls"].inc(1, op=op)
        if nbytes:
            m["bytes"].inc(nbytes, op=op)


def record_hist_psum(nbytes: int, engine: str = "incore") -> None:
    """Account the bytes one rank contributed to the histogram sync of a
    boosting round (the training loop calls this with its per-round
    total).  No-op when metrics are disabled."""
    if nbytes > 0 and _metrics.enabled():
        _coll_metrics()["hist_psum"].inc(nbytes, engine=engine)


# ---------------------------------------------------------------------------
# bootstrap: DMLC_* env ABI -> torch.distributed
# ---------------------------------------------------------------------------

def init(args: Optional[Dict[str, str]] = None,
         backend: str = "nccl") -> None:
    """Join the process group the ``DMLC_*`` env ABI describes.

    Reference parity: rabit's ``Init`` reading ``DMLC_TRACKER_URI`` /
    ``DMLC_TRACKER_PORT`` / ``DMLC_TASK_ID`` / ``DMLC_NUM_WORKER``
    (``args`` override the environment).  Those map onto
    ``init_process_group(backend, init_method="tcp://URI:PORT",
    world_size=DMLC_NUM_WORKER, rank=DMLC_TASK_ID)``; task 0 hosts the
    rendezvous store.  With ``nccl`` each rank should have selected its
    GPU (``torch.cuda.set_device``) first.

    Without a tracker URI and with at most one worker this is a no-op
    (one worker, identity collectives).  A tracker URI with one worker
    makes a group of one, which runs the synced training path on one
    card."""
    if _initialized():
        return
    CHECK(backend in BACKENDS,
          f"backend must be one of {BACKENDS}, got {backend!r}")
    env = dict(os.environ)
    if args:
        env.update(args)
    nworker = int(env.get("DMLC_NUM_WORKER", "1"))
    uri = env.get("DMLC_TRACKER_URI")
    if nworker <= 1 and uri is None:
        return
    port = env.get("DMLC_TRACKER_PORT", "9091")
    task_id = int(env.get("DMLC_TASK_ID", "0"))
    CHECK(uri is not None, "DMLC_NUM_WORKER > 1 but DMLC_TRACKER_URI unset")
    CHECK(0 <= task_id < nworker,
          f"DMLC_TASK_ID {task_id} outside [0, {nworker})")
    _dist().init_process_group(backend, init_method=f"tcp://{uri}:{port}",
                               world_size=nworker, rank=task_id)
    LOG("INFO", "dmlc collectives: process %d/%d online (%s)", task_id,
        nworker, backend)


def finalize() -> None:
    """Reference parity: rabit ``Finalize()``."""
    if _initialized():
        _dist().destroy_process_group()


def rank() -> int:
    """This worker's rank (rabit ``GetRank``): the installed transport's,
    else the group's; 0 without either."""
    t = get_host_transport()
    if t is not None:
        return t.rank
    return _dist().get_rank() if _initialized() else 0


def world_size() -> int:
    """Number of workers (rabit ``GetWorldSize``): the installed
    transport's, else the group's; 1 without either."""
    t = get_host_transport()
    if t is not None:
        return t.world
    return _dist().get_world_size() if _initialized() else 1


def _single() -> bool:
    """No process group of several ranks behind the host collectives
    (they are then the identity on this one worker)."""
    return not _initialized() or _dist().get_world_size() == 1


def is_distributed() -> bool:
    """True in a process group of more than one worker."""
    return world_size() > 1


def _group(mesh):
    return None if mesh is None else mesh.group


def _host_device(group=None) -> torch.device:
    """Where a host value crosses the wire: NCCL moves CUDA tensors
    only (this rank's current GPU), gloo CPU tensors."""
    if _dist().get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# host-level collectives (between steps, numpy in and out)
# ---------------------------------------------------------------------------

def allgather(x: np.ndarray) -> np.ndarray:
    """Gather equal-shape arrays from all workers, stacked on axis 0 in
    rank order (``[world, ...]``; ``x[None]`` on one worker)."""
    x = np.asarray(x)
    _count("allgather", x.nbytes)
    t = get_host_transport()
    if t is not None:
        return t.allgather(x)
    return _gather(x)


def _gather(x: np.ndarray) -> np.ndarray:
    if _single():
        return x[None]
    dist = _dist()
    as_u8 = x.dtype == np.bool_
    t = torch.from_numpy(np.ascontiguousarray(
        x.view(np.uint8) if as_u8 else x)).to(_host_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    res = torch.stack(out).cpu().numpy()
    return res.view(np.bool_) if as_u8 else res


def allreduce(x: np.ndarray, op: str = "sum") -> np.ndarray:
    """Allreduce a host array across workers (rabit ``Allreduce<op>``):
    an allgather, then the reduction in rank order on every worker, so
    every op is supported and float sums are bitwise identical on all
    ranks."""
    x = np.asarray(x)
    if op not in _REDUCERS:
        log_fatal(f"allreduce: unknown op {op!r}; valid: {sorted(_REDUCERS)}")
    _count("allreduce", x.nbytes)
    t = get_host_transport()
    if t is not None:
        return t.allreduce(x, op)
    if _single():
        return x
    return _REDUCERS[op](_gather(x), axis=0)


def broadcast(x: Any, root: int = 0) -> Any:
    """Broadcast a host value from ``root`` (rabit ``Broadcast``): a
    numpy array (the same shape and dtype on every rank) or any
    picklable object."""
    _count("broadcast", getattr(x, "nbytes", 0))
    t = get_host_transport()
    if t is not None:
        return t.broadcast(x, root)
    if _single():
        return x
    dist = _dist()
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(_host_device())
        dist.broadcast(t, src=root)
        return t.cpu().numpy()
    box = [x]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def barrier(name: str = "dmlc") -> None:
    """Cross-process barrier (rabit's implicit sync points, made
    explicit)."""
    _count("barrier", 0)
    t = get_host_transport()
    if t is not None:
        t.barrier(name)
        return
    if not _single():
        _dist().barrier()


# ---------------------------------------------------------------------------
# device collectives (tensors where they lie)
# ---------------------------------------------------------------------------

def _reduce_op(op: str):
    ops = {"sum": "SUM", "max": "MAX", "min": "MIN"}
    if op not in ops:
        log_fatal(f"unknown reduction {op!r}; valid: {sorted(ops)}")
    return getattr(_dist().ReduceOp, ops[op])


def _via_transport(t, x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced by the transport: a host round trip back onto the
    tensor's own device."""
    host = x.detach().cpu().numpy()
    return torch.from_numpy(np.ascontiguousarray(
        t.allreduce(host, op))).to(x.device)


def allreduce_device(x: torch.Tensor) -> torch.Tensor:
    """Sum a per-worker tensor over the workers and return the sum on the
    tensor's device (the JAX package's ``allreduce_device``): with a host
    transport a host round trip through its deterministic sum, else the
    process group's ``all_reduce`` of a copy; ``x`` itself on one
    worker."""
    t = get_host_transport()
    if t is not None:
        return _via_transport(t, x, "sum")
    if _single():
        return x
    return device_allreduce(x.clone())


def device_allreduce(x: torch.Tensor, mesh=None,
                     op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the data axis IN PLACE and return it — the
    histogram-sync primitive (``dist.all_reduce``; rabit's tree
    allreduce).  Runs whenever a process group or a host transport
    stands behind the axis, a group of one included; the identity
    without one.  Under a transport it is a host round trip (the
    transport's deterministic reduction) written back into ``x``."""
    t = get_host_transport()
    if t is not None:
        _count("device_allreduce", x.numel() * x.element_size())
        x.copy_(_via_transport(t, x, op))
        return x
    red = _reduce_op(op)
    if not _initialized():
        return x
    _count("device_allreduce", x.numel() * x.element_size())
    _dist().all_reduce(x, op=red, group=_group(mesh))
    return x


def device_allgather(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """All-gather equal-shape tensors over the data axis, concatenated
    along dim 0 in rank order (JAX's tiled ``all_gather``); under a host
    transport its ``allgather`` of the host copy."""
    t = get_host_transport()
    if t is not None:
        _count("device_allgather", x.numel() * x.element_size())
        parts = t.allgather(x.detach().cpu().numpy())
        return torch.from_numpy(np.ascontiguousarray(parts)).reshape(
            (-1,) + tuple(x.shape[1:])).to(x.device)
    if not _initialized():
        return x
    dist = _dist()
    group = _group(mesh)
    _count("device_allgather", x.numel() * x.element_size())
    world = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    # gloo gathers host tensors only
    src = x.detach().cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def device_reduce_scatter(x: torch.Tensor, mesh=None,
                          op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the data axis and leave this rank its ``1/k``
    slice of dim 0 (``x.shape[0]`` divisible by the axis size) — the
    bandwidth-optimal half of an allreduce."""
    red = _reduce_op(op)
    if not _initialized():
        return x
    dist = _dist()
    group = _group(mesh)
    k = dist.get_world_size(group)
    if x.shape[0] % k:
        log_fatal(f"reduce_scatter: dim 0 ({x.shape[0]}) not divisible by "
                  f"the data axis size {k}")
    _count("device_reduce_scatter", x.numel() * x.element_size())
    piece = x.shape[0] // k
    if op == "sum" and dist.get_backend(group) == "nccl":
        out = torch.empty((piece,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    # gloo (and max/min): reduce, then keep this rank's slice
    full = x.clone()
    dist.all_reduce(full, op=red, group=group)
    r = dist.get_rank(group)
    return full[r * piece:(r + 1) * piece].clone()


# ---------------------------------------------------------------------------
# topology math (tracker parity)
# ---------------------------------------------------------------------------

def get_tree(n: int) -> Tuple[Dict[int, int], Dict[int, List[int]]]:
    """Binary reduction tree over ranks 0..n-1 (``tracker.py ::
    get_tree``): parent(r) = (r-1)//2; returns (parent_map,
    children_map), the root's parent -1."""
    parent: Dict[int, int] = {0: -1}
    children: Dict[int, List[int]] = {r: [] for r in range(n)}
    for r in range(1, n):
        p = (r - 1) // 2
        parent[r] = p
        children[p].append(r)
    return parent, children


def find_share_ring(children: Dict[int, List[int]], root: int = 0) -> List[int]:
    """Ring order as a depth-first traversal of the tree
    (``tracker.py :: find_share_ring``)."""
    order: List[int] = []

    def dfs(r: int) -> None:
        order.append(r)
        for c in children[r]:
            dfs(c)

    dfs(root)
    return order


def get_link_map(n: int) -> Dict[int, Dict[str, Any]]:
    """Per-rank connection map: tree parent/children + ring prev/next
    (``tracker.py :: get_link_map``)."""
    parent, children = get_tree(n)
    ring = find_share_ring(children)
    pos = {r: i for i, r in enumerate(ring)}
    out: Dict[int, Dict[str, Any]] = {}
    for r in range(n):
        i = pos[r]
        out[r] = {
            "parent": parent[r],
            "children": list(children[r]),
            "ring_prev": ring[(i - 1) % n],
            "ring_next": ring[(i + 1) % n],
        }
    return out
