"""Key-range partitioner for the parameter-server shard layout.

Reference parity: ps-lite's ``Range``/``Postoffice::GetServerKeyRanges``
— the key space ``[0, n_keys)`` is cut into one contiguous range per
server (Li et al., OSDI'14 §3.2: range partitioning keeps server-side
state contiguous so aggregation buffers are flat slices, and a pull of
a sorted id batch touches each server once).  The cut uses the same
exact-tiling arithmetic as :func:`~dmlc_core_tpu_torch.parallel.mesh.
shard_row_ranges` (``lo = n*k // s``), so the ranges tile the key space
with no gaps/overlap for ANY server count, odd ones included — the
property tests in tests/test_ps.py sweep it.

Membership change (a server joins or leaves) re-cuts the ranges with
the same formula; :func:`rebalance_plan` emits the minimal contiguous
segment moves from the old layout to the new one, and its property is
the one that matters: every key appears in exactly one move target.

For id spaces where contiguous ranges would skew (sparse feature ids
clustered in a sub-range), :func:`route_hashed` routes ids through a
stable multiplicative hash — deterministic across processes and runs
(no Python hash randomization), which is what makes hashed routing a
*partition* and not a lottery.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from dmlc_core_tpu_torch.base.logging import CHECK

__all__ = ["server_ranges", "server_of", "split_by_server",
           "rebalance_plan", "route_hashed"]

#: Knuth's multiplicative hash constant (2^32 / phi); the classic
#: integer-scrambling multiplier — fixed, so routing is stable across
#: processes, restarts and Python versions
_HASH_MULT = np.uint64(2654435761)
_HASH_MASK = np.uint64(0xFFFFFFFF)


def server_ranges(n_keys: int, nservers: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` key range per server.

    Exact tiling: ``lo_k = n_keys * k // nservers`` — ranges cover
    ``[0, n_keys)`` with no gap and no overlap for any ``nservers``
    (including odd counts and ``nservers > n_keys``, where trailing
    servers get empty ranges).
    """
    CHECK(nservers >= 1, f"need at least one server, got {nservers}")
    CHECK(n_keys >= 0, f"negative key space {n_keys}")
    return [(n_keys * k // nservers, n_keys * (k + 1) // nservers)
            for k in range(nservers)]


def server_of(ids: np.ndarray, n_keys: int, nservers: int) -> np.ndarray:
    """Vectorized owner lookup: server index for each id (range
    routing).  Inverse of :func:`server_ranges`'s cut — computed by
    searchsorted over the range starts so it stays exact for every
    server count."""
    ids = np.asarray(ids, np.int64)
    starts = np.asarray([n_keys * k // nservers for k in range(nservers)],
                        np.int64)
    return (np.searchsorted(starts, ids, side="right") - 1).astype(np.int64)


def split_by_server(ids: np.ndarray, n_keys: int,
                    nservers: int) -> Dict[int, np.ndarray]:
    """Group a sparse id batch by owning server (range routing).

    Returns ``{server: positions}`` where ``positions`` indexes into
    the ORIGINAL ``ids`` array — callers slice their value arrays with
    the same positions, so one pass routes ids and payload together.
    Servers with no ids in the batch are absent (sparse push/pull only
    talks to touched shards).
    """
    ids = np.asarray(ids, np.int64)
    owners = server_of(ids, n_keys, nservers)
    out: Dict[int, np.ndarray] = {}
    for sid in np.unique(owners):
        out[int(sid)] = np.nonzero(owners == sid)[0]
    return out


def rebalance_plan(n_keys: int, old_nservers: int,
                   new_nservers: int) -> List[Tuple[int, int, int, int]]:
    """Segment moves for a membership change: re-cut the key space from
    ``old_nservers`` to ``new_nservers`` ranges and intersect the two
    grids.  Returns ``(src_server, dst_server, lo, hi)`` segments —
    the contiguous key runs each destination must fetch from each
    source.  Segments whose src == dst never move and are omitted —
    the plan is MINIMAL.  Property (tested): replaying the plan over
    the old ownership map yields exactly the new tiling, so a re-range
    after join/leave preserves every key.
    """
    old = server_ranges(n_keys, old_nservers)
    new = server_ranges(n_keys, new_nservers)
    cuts = sorted({b for lo, hi in old + new for b in (lo, hi)})
    plan: List[Tuple[int, int, int, int]] = []
    for lo, hi in zip(cuts, cuts[1:]):
        if lo == hi:
            continue
        src = int(server_of(np.asarray([lo]), n_keys, old_nservers)[0])
        dst = int(server_of(np.asarray([lo]), n_keys, new_nservers)[0])
        if src != dst:
            plan.append((src, dst, lo, hi))
    return plan


def route_hashed(ids: np.ndarray, nservers: int) -> np.ndarray:
    """Stable hashed routing: server index per id via a fixed
    multiplicative hash (no range locality assumption — the mode for
    id spaces where contiguous ranges would skew load).  Deterministic
    across calls, processes and runs: the multiplier is a module
    constant, not a salted ``hash()``."""
    CHECK(nservers >= 1, f"need at least one server, got {nservers}")
    ids = np.asarray(ids, np.int64).astype(np.uint64)
    h = (ids * _HASH_MULT) & _HASH_MASK
    return ((h * np.uint64(nservers)) >> np.uint64(32)).astype(np.int64)
