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
    "psum", "replicate_fwd_psum_bwd", "psum_fwd_identity_bwd",
    "all_to_all", "ppermute", "psum_scatter", "all_gather",
    "wire_bytes", "reset_wire_bytes",
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
    return None if mesh is None else mesh.group("data")


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


def broadcast(x: Any, root: int = 0, mesh=None) -> Any:
    """Broadcast a host value from ``root`` (rabit ``Broadcast``): a
    numpy array (the same shape and dtype on every rank) or any
    picklable object.  With ``mesh``, over its ``data`` axis only, from
    the axis position ``root`` (a data axis of one: the identity)."""
    _count("broadcast", getattr(x, "nbytes", 0))
    t = get_host_transport()
    if t is not None:
        return t.broadcast(x, root)
    if _single():
        return x
    dist = _dist()
    group = _group(mesh)
    if mesh is not None:
        if mesh.axis_size("data") == 1:
            return x
        root = mesh.axis_ranks("data")[root]
    if isinstance(x, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(_host_device(group))
        dist.broadcast(t, src=root, group=group)
        return t.cpu().numpy()
    box = [x]
    dist.broadcast_object_list(box, src=root, group=group)
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
    _reduce_op(op)
    if not _initialized():
        return x
    _count("device_allreduce", x.numel() * x.element_size())
    return _reduce_into(x, _group(mesh), op)


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
    _count("device_allgather", x.numel() * x.element_size())
    return _raw_all_gather(x, _group(mesh), 0)


def device_reduce_scatter(x: torch.Tensor, mesh=None,
                          op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the data axis and leave this rank its ``1/k``
    slice of dim 0 (``x.shape[0]`` divisible by the axis size) — the
    bandwidth-optimal half of an allreduce."""
    _reduce_op(op)
    if not _initialized():
        return x
    _count("device_reduce_scatter", x.numel() * x.element_size())
    return _raw_psum_scatter(x, _group(mesh), 0, op)


# ---------------------------------------------------------------------------
# axis collectives: a mesh axis's process group, inside a model's step
# ---------------------------------------------------------------------------
#
# The JAX package writes these as ``lax`` collectives over a named axis of
# a ``shard_map``; here each rank is a process and an axis is the process
# group of its line of the mesh (``Mesh.group(axis)``).  Each is a
# ``torch.autograd.Function`` whose backward is the transpose JAX's AD
# gives the collective under ``shard_map(check_vma=False)``:
#
# * psum → psum (the cotangents of every rank's copy summed);
# * all_to_all(split a, concat c) → all_to_all(split c, concat a);
# * ppermute(perm) → ppermute(the inverse perm);
# * psum_scatter → all_gather, and all_gather → psum_scatter.
#
# Megatron's pair is :func:`replicate_fwd_psum_bwd` (*f*: identity, then
# psum of the cotangents) and :func:`psum_fwd_identity_bwd` (*g*: psum,
# then the cotangent as it is — the downstream loss is replicated over the
# axis, so each rank already holds the whole cotangent).
#
# The ``_raw_*`` functions below move the data for these and for the
# ``device_*`` collectives above (the data axis's group).  NCCL moves
# CUDA tensors where they lie (``all_reduce``, ``all_gather_into_tensor``,
# ``reduce_scatter_tensor``).  gloo's CUDA support is narrower than its
# CPU support, so under gloo a CUDA tensor is staged through host memory
# explicitly: copied to the CPU, moved, copied back.  Data-moving
# collectives under gloo (all_to_all, ppermute, all_gather) send the
# tensor's bytes (a ``uint8`` view), so every dtype travels alike.  An
# axis of size one is the identity and moves nothing.

_WIRE = {"bytes": 0}
_HALF = (torch.bfloat16, torch.float16)


def wire_bytes() -> int:
    """Payload bytes this process has put into the device and axis
    collectives since the last :func:`reset_wire_bytes`."""
    return _WIRE["bytes"]


def reset_wire_bytes() -> None:
    _WIRE["bytes"] = 0


def _gloo(group) -> bool:
    return _dist().get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend takes it: under gloo a CUDA tensor is
    staged into host memory; contiguous either way."""
    _WIRE["bytes"] += x.numel() * x.element_size()
    if x.is_cuda and _gloo(group):
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).view(torch.uint8) if t.dim() else \
        t.reshape(1).view(torch.uint8)


def _reduce_into(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` (contiguous) reduced over ``group`` IN PLACE, and returned.
    Under gloo a CUDA tensor, and a 16-bit float (which gloo sums through
    f32, one rounding at the end), is reduced in a host copy that is
    then written back."""
    red = _reduce_op(op)
    _WIRE["bytes"] += x.numel() * x.element_size()
    if _gloo(group) and (x.is_cuda or x.dtype in _HALF):
        w = x.detach().to("cpu", torch.float32 if x.dtype in _HALF
                          else x.dtype, copy=True)
        _dist().all_reduce(w, op=red, group=group)
        x.copy_(w)
        return x
    _dist().all_reduce(x, op=red, group=group)
    return x


def _raw_psum(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over ``group``, a new tensor."""
    return _reduce_into(x.detach().clone(
        memory_format=torch.contiguous_format), group, op)


def _raw_all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    dist = _dist()
    n = dist.get_world_size(group)
    _WIRE["bytes"] += x.numel() * x.element_size()
    if not _gloo(group):
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out.view(-1), x.detach().contiguous()
                                    .view(-1), group=group)
        return torch.cat(out.unbind(0), dim=dim)
    src = x.detach().to("cpu").contiguous()
    b = _as_bytes(src.unsqueeze(0))
    parts = [torch.empty_like(b) for _ in range(n)]
    dist.all_gather(parts, b, group=group)
    got = [p.view(x.dtype).reshape(x.shape) for p in parts]
    return torch.cat(got, dim=dim).to(x.device)


def _raw_psum_scatter(x: torch.Tensor, group, dim: int,
                      op: str = "sum") -> torch.Tensor:
    """The reduction of ``x`` over ``group``, this rank keeping its
    ``1/n`` block of ``dim``: NCCL's ``reduce_scatter_tensor`` moves
    each block once; gloo (and max/min) reduce the whole and slice."""
    dist = _dist()
    n = dist.get_world_size(group)
    CHECK(x.shape[dim] % n == 0, f"reduce_scatter: dim {dim} "
          f"({x.shape[dim]}) not divisible by the axis size {n}")
    if op == "sum" and not _gloo(group):
        _WIRE["bytes"] += x.numel() * x.element_size()
        xs = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xs, group=group)
        return out.movedim(0, dim).contiguous()
    full = _raw_psum(x, group, op)
    return full.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


def _raw_all_to_all(x: torch.Tensor, group, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    n = _dist().get_world_size(group)
    CHECK(x.shape[split_axis] % n == 0,
          f"all_to_all: dim {split_axis} ({x.shape[split_axis]}) not "
          f"divisible by the axis size {n}")
    # chunk j goes to axis position j; the received chunks concatenate on
    # concat_axis in source order (JAX's tiled all_to_all)
    send = torch.stack(x.chunk(n, dim=split_axis))
    w = _wire(send, group)
    b = _as_bytes(w)
    out = torch.empty_like(b)
    _dist().all_to_all_single(out, b, group=group)
    recv = out.view(x.dtype).reshape(send.shape).to(x.device)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _raw_ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    dist = _dist()
    group = mesh.group(axis)
    me = mesh.axis_index(axis)
    ranks = mesh.axis_ranks(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    CHECK(len(dst) <= 1 and len(src) <= 1, "ppermute: not a permutation")
    if dst == [me] and src == [me]:
        return x.clone()
    w = _wire(x, group)
    out = torch.zeros_like(w)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, _as_bytes(w.reshape(-1)),
                              ranks[dst[0]], group))
    if src:
        ops.append(dist.P2POp(dist.irecv, _as_bytes(out.reshape(-1)),
                              ranks[src[0]], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _raw_psum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return _raw_psum(ct, ctx.group), None


class _ReplicateFwdPsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _raw_psum(ct, ctx.group), None


class _PsumFwdIdentityBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _raw_psum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _raw_all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        return _raw_all_to_all(ct, *ctx.args), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inv = tuple((d, s) for s, d in perm)
        return _raw_ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, ct):
        return _raw_ppermute(ct, ctx.mesh, ctx.axis, ctx.inv), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _raw_psum_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _raw_all_gather(ct, *ctx.args), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _raw_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _raw_psum_scatter(ct, *ctx.args), None, None


def _axes(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def psum(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` of ``mesh`` (a name or a
    tuple of names, reduced one axis after another) on every rank
    (``lax.psum``); backward: psum of the cotangents."""
    for ax in _axes(axis):
        if mesh.axis_size(ax) > 1:
            x = _Psum.apply(x, mesh.group(ax))
    return x


def replicate_fwd_psum_bwd(x: torch.Tensor, axis: str,
                           mesh) -> torch.Tensor:
    """Identity forward, ``psum`` over ``axis`` backward (Megatron's
    *f*; JAX ``collectives.replicate_fwd_psum_bwd``).  Marks where a
    replicated activation enters computation sharded over ``axis``: every
    shard then holds the COMPLETE gradient of what lies upstream."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ReplicateFwdPsumBwd.apply(x, mesh.group(axis))


def psum_fwd_identity_bwd(x: torch.Tensor, axis: str,
                          mesh) -> torch.Tensor:
    """``psum`` over ``axis`` forward, identity backward (Megatron's
    *g*, the row-parallel join): what follows is replicated over the
    axis, so each shard's cotangent is already the whole one."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumFwdIdentityBwd.apply(x, mesh.group(axis))


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, mesh) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all``: ``x`` split into ``axis_size``
    chunks along ``split_axis``, chunk ``j`` sent to axis position
    ``j``, the received chunks concatenated along ``concat_axis`` in
    source order.  (JAX's untiled form over a leading dim of the axis's
    size is this with ``split_axis = concat_axis = 0``.)"""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh.group(axis), split_axis, concat_axis)


def ppermute(x: torch.Tensor, axis: str, perm, mesh) -> torch.Tensor:
    """``lax.ppermute``: axis position ``s`` sends ``x`` to ``d`` for each
    ``(s, d)`` of ``perm``; a position nothing is sent to gets zeros."""
    if mesh.axis_size(axis) == 1:
        return x.clone() if any(s == d for s, d in perm) else \
            torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis, tuple(tuple(p) for p in perm))


def psum_scatter(x: torch.Tensor, axis: str, mesh,
                 dim: int = 0) -> torch.Tensor:
    """The sum over ``axis``, each rank keeping its ``1/P`` block of
    ``dim`` (JAX's tiled ``lax.psum_scatter``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumScatter.apply(x, mesh.group(axis), dim)


def all_gather(x: torch.Tensor, axis: str, mesh,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order (JAX's
    tiled ``lax.all_gather``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), dim)


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
