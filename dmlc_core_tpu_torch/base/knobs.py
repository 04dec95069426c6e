"""Declared ``DMLC_*`` environment knobs of the streaming and distributed
state modules, with their defaults.

This package's own copy of the part of ``dmlc_core_tpu/base/knobs.py``
that the streaming (``stream/``), key-value store (``parallel/kvstore``),
parameter server (``parallel/ps``) and elastic recovery
(``parallel/recovery``) modules, the dynamic checkers (``base/lockcheck``,
``base/racecheck``, ``base/leakcheck``) and the bench's ``--prodsim``
read: the same names, defaults and
meanings.  :func:`value` reads a knob from the environment with its
declared default applied, the type taken from the default.  Reads happen
at the call (no caching), so a test or a worker thread sees the
environment as it is when it constructs its object.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

from dmlc_core_tpu_torch.base.parameter import get_env

__all__ = ["Knob", "declare", "value"]


class Knob(NamedTuple):
    name: str
    default: Any
    doc: str


_REGISTRY: Dict[str, Knob] = {}


def declare(name: str, default: Any, doc: str) -> Knob:
    """Register a knob (re-declaring with other fields raises)."""
    k = Knob(name, default, doc)
    old = _REGISTRY.setdefault(name, k)
    if old != k:
        raise ValueError(f"knob {name!r} re-declared: {old} vs {k}")
    return k


def value(name: str) -> Any:
    """The knob's environment value, or its declared default."""
    k = _REGISTRY.get(name)
    if k is None:
        raise KeyError(f"knob {name!r} is not declared in base/knobs.py")
    return get_env(k.name, k.default)


# -- checkpoints and elastic recovery ----------------------------------------
declare("DMLC_RECOVERY_STRIDE", 5,
        "Boosting rounds between round-versioned collective checkpoint "
        "commits (the elastic-recovery floor granularity).")
declare("DMLC_ELASTIC", "0",
        "1 re-shards the surviving workers once a lost worker's grace "
        "lapses; 0 holds the world for a rejoining replacement.")
declare("DMLC_RECOVERY_DIR", "",
        "Directory for per-rank round-versioned recovery checkpoints; "
        "empty requires an explicit recovery_dir=.")

# -- streaming / online learning ---------------------------------------------
declare("DMLC_STREAM_POLL_S", 0.05,
        "Tailer base poll interval in seconds; idle polls back off "
        "exponentially (with jitter) from here.")
declare("DMLC_STREAM_MAX_BACKOFF_S", 1.0,
        "Cap on the tailer's jittered idle-poll backoff in seconds.")
declare("DMLC_STREAM_CURSOR", "",
        "Default cursor checkpoint URI for RecordIOTailer.commit; empty = "
        "no default.")
declare("DMLC_STREAM_CHUNK_ROWS", 2048,
        "Fresh event rows gathered per online-trainer refresh.")
declare("DMLC_STREAM_WINDOW_CHUNKS", 4,
        "Sliding training window length in chunks.")
declare("DMLC_STREAM_DECAY", 1.0,
        "Per-chunk-age sample-weight decay in (0, 1]; 1.0 = pure sliding "
        "window (no weights, warm-start parity).")
declare("DMLC_STREAM_EVAL_GATE", 0.1,
        "Publisher eval-gate relative tolerance.")

# -- distributed ABI ----------------------------------------------------------
declare("DMLC_ROLE", "worker",
        "Process role in a distributed job: worker / server / scheduler.")
declare("DMLC_NUM_WORKER", 1, "Worker count the tracker coordinates.")
declare("DMLC_NUM_SERVER", 0, "Parameter-server count (PS ABI).")
declare("DMLC_TASK_ID", 0, "This worker's task index within the job.")
declare("DMLC_PS_ROOT_URI", "", "PS scheduler host (PSTracker env ABI).")
declare("DMLC_PS_ROOT_PORT", "", "PS scheduler port (PSTracker env ABI).")
declare("DMLC_KVSTORE_CHECK", 0,
        "1 cross-checks that every worker pulled the same KVStore key "
        "batch before the fused dist_sync reduction (debug).")

# -- parameter server ---------------------------------------------------------
declare("DMLC_PS_STALENESS", 4,
        "Bounded-staleness window tau for dist_async pulls; 0 = BSP, "
        "negative = fully async.")
declare("DMLC_PS_PIPELINE", 8,
        "In-flight request window per server connection.")
declare("DMLC_PS_PULL_TIMEOUT_S", 60.0,
        "Seconds a pull may wait on the server-side staleness gate.")
declare("DMLC_PS_RECONNECT_S", 30.0,
        "Deadline in seconds for re-dialing a lost server connection.")
declare("DMLC_PS_SNAPSHOT_DIR", "",
        "Directory for per-server shard snapshots; empty disables them.")
declare("DMLC_PS_SNAPSHOT_STRIDE", 0,
        "Committed clock ticks between shard snapshots; 0 disables.")
declare("DMLC_PS_SERVER_ID", -1,
        "Server shard id for DMLC_ROLE=server processes; -1 lets the "
        "scheduler assign the next free id.")
declare("DMLC_PS_SERVER_URI", "127.0.0.1",
        "Host/interface a DMLC_ROLE=server process binds its data plane "
        "to.")

# -- dynamic checkers (installed at import by dmlc_core_tpu_torch/__init__) ---
declare("DMLC_LOCKCHECK", "0",
        "1 installs the dynamic lock-order verifier at import: lock "
        "acquisitions build a cross-thread order graph and cycles are "
        "reported (base/lockcheck).")
declare("DMLC_RACECHECK", "0",
        "1 installs the vector-clock happens-before race detector at "
        "import (implies lock tracing): shared-attribute accesses on "
        "the instrumented serving/tracker classes are checked for "
        "unordered cross-thread pairs (base/racecheck).")
declare("DMLC_LEAKCHECK", "0",
        "1 installs the resource-leak tracer at import: every "
        "socket/thread/subprocess/tempfile created through repo code "
        "is recorded with its creation stack, and whatever is still "
        "live at drill exit is reported (base/leakcheck).")

# -- the production-day drill (bench --prodsim) --------------------------------
declare("DMLC_FAULT_SEED", 1234,
        "Seed for the per-rule fault-injection RNG streams.")
declare("DMLC_PRODSIM_SECONDS", 24.0,
        "Duration of the bench --prodsim production-day simulation "
        "load window in seconds (the chaos schedule scales with it).")
declare("DMLC_PRODSIM_CHAOS", "",
        "Override chaos schedule for bench --prodsim (faultinject "
        "grammar with at=/every= wall-clock triggers); empty derives "
        "the default all-tier schedule from DMLC_PRODSIM_SECONDS.")
