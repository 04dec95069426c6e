"""Device meshes over a ``torch.distributed`` world, one process per GPU.

The counterpart of ``dmlc_core_tpu/parallel/mesh.py``.  The JAX package
has one controller over a named device mesh; PyTorch's idiom is one
process per GPU, so here a mesh is the world of a process group laid out
on named axes, and this process is one position on it.

* :class:`Mesh` — the ``data`` axis alone over a process group: its size
  is the group's world size (1 when no group is initialised).  Rows are
  split over the axis by :func:`shard_row_ranges`; everything else (cuts,
  trees, split decisions) is replicated, each rank computing it from the
  synced histograms.  Under a host transport
  (``collectives.set_host_transport``, the elastic recovery layer's
  tracker hub) the axis is the transport's world: its size and rank are
  the transport's, read on the calling thread.  ``local_mesh()`` is this
  mesh, as JAX's ``local_mesh`` is its one-axis ``data`` mesh.
* :func:`create_mesh` — all five axes of :data:`AXES` (``data``,
  ``model``, ``pipe``, ``seq``, ``expert``) over the world, sized by a
  :class:`MeshSpec`.  Rank ``r`` sits at ``np.unravel_index(r, shape)``
  in ``AXES`` order, the JAX package's row-major ``reshape`` of its
  devices, so port rank ``r`` is JAX device ``r``.  Each axis has one
  process group per slice of the other coordinates (every rank creates
  all of them, in the same order, as ``dist.new_group`` requires);
  :meth:`Mesh.group` returns this rank's.

A single process driving several GPUs is not supported.
:func:`shard_row_ranges` and :func:`row_shard_layout` are the JAX
package's row math, value for value.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ
from dmlc_core_tpu_torch.base.parameter import Parameter, field

__all__ = ["AXES", "Mesh", "MeshSpec", "create_mesh", "local_mesh",
           "device_count", "shard_row_ranges", "row_shard_layout"]

# canonical axis order; unused axes get size 1 and cost nothing
AXES: Tuple[str, ...] = ("data", "model", "pipe", "seq", "expert")


def _dist():
    import torch.distributed as dist

    return dist


def _transport():
    from dmlc_core_tpu_torch.parallel.collectives import get_host_transport

    return get_host_transport()


class Mesh:
    """The ``data`` axis over a process group (``group=None``: the
    default group).  ``size`` is 1 and ``rank`` 0 while no group is
    initialised, so a model built on it trains on one device.

    Every mesh answers the named-axis queries (``axis_names``,
    :meth:`axis_size`, :meth:`axis_index`, :meth:`group`); here the one
    axis is ``data``."""

    axis_names: Tuple[str, ...] = ("data",)

    def __init__(self, group=None):
        self._group = group

    def group(self, axis: str = "data"):
        """The process group of ``axis`` through this rank (None: the
        default group)."""
        CHECK_EQ(axis, "data", f"mesh has no axis {axis!r}")
        return self._group

    def axis_size(self, axis: str) -> int:
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        return self.size

    def axis_index(self, axis: str) -> int:
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        return self.rank

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        if not self.initialized or _transport() is not None:
            return list(range(self.size))
        dist = _dist()
        return [dist.get_global_rank(self._group, i) if self._group
                is not None else i for i in range(self.size)]

    @property
    def initialized(self) -> bool:
        """True when a process group or this thread's host transport
        stands behind the axis (the histogram sync then runs, even on a
        world of one)."""
        if _transport() is not None:
            return True
        dist = _dist()
        return dist.is_available() and dist.is_initialized()

    @property
    def size(self) -> int:
        t = _transport()
        if t is not None:
            return t.world
        return (_dist().get_world_size(self._group) if self.initialized
                else 1)

    @property
    def rank(self) -> int:
        t = _transport()
        if t is not None:
            return t.rank
        return _dist().get_rank(self._group) if self.initialized else 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def row_range(self, n_rows: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of ``n_rows`` global rows."""
        return shard_row_ranges(n_rows, self.size)[self.rank]

    def __repr__(self) -> str:
        return f"Mesh(data={self.size}, rank={self.rank})"


class MeshSpec(Parameter):
    """Mesh shape as a Parameter (env/config/CLI-settable).

    ``-1`` on exactly one axis means "all remaining devices" (like a numpy
    reshape wildcard); the default puts every device on ``data``.
    """

    data = field(int, default=-1, description="data-parallel axis size")
    model = field(int, default=1, description="tensor-parallel axis size")
    pipe = field(int, default=1, description="pipeline-parallel axis size")
    seq = field(int, default=1, description="sequence/context-parallel axis size")
    expert = field(int, default=1, description="expert-parallel axis size")

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {ax: getattr(self, ax) for ax in AXES}
        wild = [ax for ax, s in sizes.items() if s == -1]
        CHECK(len(wild) <= 1, "at most one mesh axis may be -1")
        fixed = int(np.prod([s for s in sizes.values() if s != -1]))
        if wild:
            CHECK_EQ(n_devices % fixed, 0,
                     f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        else:
            CHECK_EQ(fixed, n_devices, f"mesh {sizes} != {n_devices} devices")
        return sizes


class _NamedMesh(Mesh):
    """The five named axes over the world (see :func:`create_mesh`)."""

    def __init__(self, sizes: Dict[str, int], rank: int, groups, ranks):
        super().__init__(groups.get("data"))
        self.axis_names = tuple(sizes)
        self._sizes = dict(sizes)
        self._rank = rank
        self._coords = dict(zip(self.axis_names, (int(c) for c in (
            np.unravel_index(rank, tuple(sizes.values()))))))
        self._groups = groups
        self._ranks = ranks

    def group(self, axis: str = "data"):
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        return self._groups.get(axis)

    def axis_size(self, axis: str) -> int:
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        return self._sizes[axis]

    def axis_index(self, axis: str) -> int:
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        return self._coords[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        CHECK(axis in self.axis_names, f"mesh has no axis {axis!r}")
        return list(self._ranks[axis])

    @property
    def initialized(self) -> bool:
        return self._groups.get("data") is not None

    @property
    def size(self) -> int:
        return self._sizes["data"] if "data" in self._sizes else 1

    @property
    def rank(self) -> int:
        return self._coords.get("data", 0)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._sizes)

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={s}' for a, s in self._sizes.items())}"
                f", rank={self._rank})")


def create_mesh(spec: Optional[MeshSpec] = None,
                axis_names: Tuple[str, ...] = AXES) -> Mesh:
    """A named mesh of ``axis_names`` (default: all of :data:`AXES`) over
    the process group's world, sized by ``spec`` (default: every rank on
    ``data``).  Rank ``r`` sits at ``np.unravel_index(r, shape)``.

    Collective over the world: every rank calls it with the same
    arguments, and it creates one process group per axis and slice of the
    other coordinates, axis by axis in ``axis_names`` order and slices in
    row-major order (axes of size 1 included, so that :meth:`Mesh.group`
    always has a group under a process group).  Without a process group
    the world is this one process and no group is made."""
    dist = _dist()
    on = dist.is_available() and dist.is_initialized()
    CHECK(_transport() is None, "create_mesh: a host transport's world has "
          "no process groups (the named axes need torch.distributed)")
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    spec = spec or MeshSpec()
    sizes_all = spec.resolve(world)
    for ax in AXES:
        CHECK(ax in axis_names or sizes_all[ax] == 1,
              f"create_mesh: axis {ax!r} has size {sizes_all[ax]} but is "
              "not named")
    sizes = {ax: sizes_all[ax] for ax in axis_names}
    shape = tuple(sizes.values())
    grid = np.arange(world).reshape(shape)
    groups: Dict[str, object] = {}
    ranks: Dict[str, List[int]] = {}
    for d, ax in enumerate(axis_names):
        lines = np.moveaxis(grid, d, -1).reshape(-1, shape[d])
        for line in lines:
            members = [int(r) for r in line]
            g = dist.new_group(members) if on else None
            if rank in members:
                groups[ax], ranks[ax] = g, members
    return _NamedMesh(sizes, rank, groups, ranks)


def local_mesh(n: Optional[int] = None, axis: str = "data") -> Mesh:
    """The data axis over the default process group.  ``n``, when given,
    must equal its size: with one process per GPU the axis cannot be cut
    to fewer devices than the group has."""
    CHECK_EQ(axis, "data", "the port's mesh has one axis, 'data'")
    mesh = Mesh()
    if n is not None:
        CHECK_EQ(n, mesh.size, "local_mesh(n): n must equal the process "
                 "group's world size (one process per GPU)")
    return mesh


def device_count(mesh: Union[Mesh, int]) -> int:
    """Devices in the mesh (one per process): the product of its axis
    sizes.  An int stands for a data axis of that many devices — the row
    math below on a hypothetical group."""
    if isinstance(mesh, int):
        return mesh
    return int(np.prod([mesh.axis_size(a) for a in mesh.axis_names]))


def shard_row_ranges(n_rows: int, nparts: int) -> List[Tuple[int, int]]:
    """Exact row partition over ``nparts``: part ``k`` owns rows
    ``[n·k/nparts, n·(k+1)/nparts)`` — disjoint, ordered, covering
    ``[0, n_rows)`` for any sizes, the remainder spread over the parts
    (the reference's ``InputSplit(part, nparts)`` contract on rows)."""
    CHECK(nparts >= 1, f"shard_row_ranges: nparts must be >= 1, got {nparts}")
    CHECK(n_rows >= 0, f"shard_row_ranges: n_rows must be >= 0, got {n_rows}")
    return [(n_rows * k // nparts, n_rows * (k + 1) // nparts)
            for k in range(nparts)]


def row_shard_layout(n_rows: int, mesh: Union[Mesh, int],
                     pad_multiple: int = 0) -> Tuple[int, int]:
    """``(n_padded, shard_rows)`` of an equal-block placement: rows pad
    to a device-count multiple (or ``pad_multiple`` when larger) and
    device ``k`` owns ``[k·shard_rows, (k+1)·shard_rows)`` — the JAX
    package's placement math.  The port's fit does not pad (each rank
    holds its :func:`shard_row_ranges` rows); this serves callers that
    need equal blocks."""
    ndev = device_count(mesh)
    m = max(pad_multiple, ndev)
    CHECK_EQ(m % ndev, 0,
             f"pad_multiple {pad_multiple} must be a device-count "
             f"({ndev}) multiple")
    n_padded = n_rows + ((-n_rows) % m)
    if n_padded == 0:
        n_padded = m
    return n_padded, n_padded // ndev


Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_block(arr, spec: Spec, mesh: Mesh):
    """This rank's block of a global array (numpy or tensor) laid out by
    ``spec`` — JAX's ``PartitionSpec``: per dimension ``None``
    (replicated), an axis name, or a tuple of names (the dimension split
    over their product, the first name major).  Absent axes and axes of
    size one do not split."""
    idx = []
    for d, entry in enumerate(spec):
        axes = [a for a in _spec_axes(entry) if a in mesh.axis_names]
        n, k = 1, 0
        for a in axes:
            k = k * mesh.axis_size(a) + mesh.axis_index(a)
            n *= mesh.axis_size(a)
        size = arr.shape[d]
        CHECK_EQ(size % n, 0, f"dim {d} ({size}) not divisible by the "
                 f"{tuple(axes)} axes ({n})")
        step = size // n
        idx.append(slice(k * step, (k + 1) * step))
    return arr[tuple(idx)]


def gather_block(t, spec: Spec, mesh: Mesh):
    """The global tensor from every rank's :func:`local_block` (collective
    over the axes ``spec`` names; an all-gather per sharded dimension), a
    copy: it shares no memory with ``t``.  No gradient flows."""
    from dmlc_core_tpu_torch.parallel.collectives import _raw_all_gather

    t = t.detach().clone()
    for d, entry in enumerate(spec):
        for a in reversed([a for a in _spec_axes(entry)
                           if a in mesh.axis_names]):
            if mesh.axis_size(a) > 1:
                t = _raw_all_gather(t, mesh.group(a), d)
    return t
