"""The data axis: a ``torch.distributed`` process group, one process per
GPU.

The counterpart of ``dmlc_core_tpu/parallel/mesh.py``.  The JAX package
has one controller over a named device mesh; PyTorch's idiom is one
process per GPU, so here the ``data`` axis is the world of a process
group: its size is the group's world size (1 when no group is
initialised) and this process is one position on it.  Rows are split
over the axis by :func:`shard_row_ranges`; everything else (cuts, trees,
split decisions) is replicated, each rank computing it from the synced
histograms.  A single process driving several GPUs is not supported.
Under a host transport (``collectives.set_host_transport``, the elastic
recovery layer's tracker hub) the axis is the transport's world: its size
and rank are the transport's, read on the calling thread.

:func:`shard_row_ranges` and :func:`row_shard_layout` are the JAX
package's row math, value for value.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from dmlc_core_tpu_torch.base.logging import CHECK, CHECK_EQ

__all__ = ["Mesh", "local_mesh", "device_count", "shard_row_ranges",
           "row_shard_layout"]


def _dist():
    import torch.distributed as dist

    return dist


def _transport():
    from dmlc_core_tpu_torch.parallel.collectives import get_host_transport

    return get_host_transport()


class Mesh:
    """The ``data`` axis over a process group (``group=None``: the
    default group).  ``size`` is 1 and ``rank`` 0 while no group is
    initialised, so a model built on it trains on one device."""

    axis_names: Tuple[str, ...] = ("data",)

    def __init__(self, group=None):
        self.group = group

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
        return (_dist().get_world_size(self.group) if self.initialized
                else 1)

    @property
    def rank(self) -> int:
        t = _transport()
        if t is not None:
            return t.rank
        return _dist().get_rank(self.group) if self.initialized else 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def row_range(self, n_rows: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of ``n_rows`` global rows."""
        return shard_row_ranges(n_rows, self.size)[self.rank]

    def __repr__(self) -> str:
        return f"Mesh(data={self.size}, rank={self.rank})"


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
    """Devices on the axis (one per process).  An int stands for an axis
    of that many devices — the row math below on a hypothetical group."""
    return mesh if isinstance(mesh, int) else mesh.size


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
