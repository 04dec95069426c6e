"""Central registry of every ``DMLC_*`` environment knob the port reads.

This package's own copy of ``dmlc_core_tpu/base/knobs.py``: every
``DMLC_*`` name that appears as a string literal in the port's code is
declared here with its default, a one-line doc and its group, and
``tests/test_torch_knobs.py`` holds that.  Where the JAX package declares
the same name, the default, doc and group are its; where the port's
meaning differs, the default stays the JAX package's and the doc says
what the port does.  Knobs only the port reads carry their own doc.

Declaring a knob does not change how call sites read it (``os.environ``
/ :func:`~dmlc_core_tpu_torch.base.parameter.get_env` stay as they are);
:func:`value` reads a knob from the environment with its declared default
applied, the type taken from the default.  Reads happen at the call (no
caching), so a test or a worker thread sees the environment as it is when
it constructs its object.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

from dmlc_core_tpu_torch.base.parameter import get_env

__all__ = ["Knob", "declare", "get", "all_knobs", "names", "value"]


class Knob(NamedTuple):
    """One declared environment knob."""

    #: full environment-variable name (``DMLC_...``)
    name: str
    #: default the reading call site applies when the var is unset
    default: Any
    #: one-line description
    doc: str
    #: subsystem bucket (the JAX package's doc table ordering)
    group: str


_REGISTRY: Dict[str, Knob] = {}


def declare(name: str, default: Any, doc: str, group: str = "misc") -> Knob:
    """Register a knob; re-declaring with identical fields is a no-op,
    conflicting re-declaration raises."""
    if not name.startswith("DMLC_"):
        raise ValueError(f"knob {name!r} must start with DMLC_")
    k = Knob(name, default, doc, group)
    old = _REGISTRY.setdefault(name, k)
    if old != k:
        raise ValueError(f"knob {name!r} re-declared with different "
                         f"fields: {old} vs {k}")
    return old


def get(name: str) -> Optional[Knob]:
    """Look up a declared knob (None when unknown)."""
    return _REGISTRY.get(name)


def names() -> List[str]:
    """All declared knob names, sorted."""
    return sorted(_REGISTRY)


def all_knobs() -> List[Knob]:
    """All declared knobs, sorted by (group, name)."""
    return sorted(_REGISTRY.values(), key=lambda k: (k.group, k.name))


def value(name: str) -> Any:
    """The knob's environment value, or its declared default."""
    k = _REGISTRY.get(name)
    if k is None:
        raise KeyError(f"knob {name!r} is not declared in base/knobs.py")
    return get_env(k.name, k.default)


# ---------------------------------------------------------------------------
# The declarations, grouped as the JAX package groups them.
# ---------------------------------------------------------------------------

# -- runtime ---------------------------------------------------------------
declare("DMLC_TPU_NATIVE_IO", "1",
        "0 disables the C fast paths (recordio/parsers/queues) in favor "
        "of pure-Python fallbacks.",
        group="runtime")
declare("DMLC_TPU_NATIVE_LIB", "",
        "Explicit path to the native helper shared library (overrides "
        "the build base/_native_build makes on first use).",
        group="runtime")

# -- observability ---------------------------------------------------------
declare("DMLC_LEAKCHECK", "0",
        "1 installs the resource-leak tracer at import: every "
        "socket/thread/subprocess/tempfile created through repo code is "
        "recorded with its creation stack, and whatever is still live "
        "at drill exit is reported (base/leakcheck).",
        group="observability")
declare("DMLC_LOCKCHECK", "0",
        "1 installs the dynamic lock-order verifier at import: lock "
        "acquisitions build a cross-thread order graph and cycles are "
        "reported (base/lockcheck).",
        group="observability")
declare("DMLC_METRICS", "1",
        "0 disables the metrics registry: instruments become no-ops "
        "(base/metrics).",
        group="observability")
declare("DMLC_METRICS_GBT_PHASES", "0",
        "1 adds per-phase hist/split/leaf/apply timing in the external "
        "GBT engine (adds device syncs).",
        group="observability")
declare("DMLC_METRICS_SPOOL", "",
        "Directory for the cross-process metrics spool: each process "
        "writes its registry snapshot (and trace shard) there for "
        "fleet-wide merging (base/metrics_agg); empty disables.",
        group="observability")
declare("DMLC_METRICS_SPOOL_S", 2.0,
        "Seconds between periodic spool snapshot flushes; <= 0 keeps "
        "only the at-exit flush.",
        group="observability")
declare("DMLC_RACECHECK", "0",
        "1 installs the vector-clock happens-before race detector at "
        "import (implies lock tracing): shared-attribute accesses on "
        "the instrumented serving/tracker classes are checked for "
        "unordered cross-thread pairs (base/racecheck).",
        group="observability")
declare("DMLC_SLO_SPEC", "",
        "Default SLO spec JSON path for scoring the port bench's final "
        "record (base/slo; python -m dmlc_core_tpu_torch.bench --slo "
        "overrides); empty disables.",
        group="observability")
declare("DMLC_TRACE", "0",
        "1 enables the process-wide event Tracer "
        "(utils/profiler.set_tracing).",
        group="observability")
declare("DMLC_TRACE_CTX", "",
        "Wire-encoded trace context a launcher injects so child "
        "processes join the parent's distributed trace (base/tracectx); "
        "empty starts fresh.",
        group="observability")

# -- gbt -------------------------------------------------------------------
declare("DMLC_BIN_PACK", "0",
        "1 packs narrow features two-per-byte (int4) in the transposed "
        "bin matrix: features whose OCCUPIED bin count is <= 16 are "
        "compact-remapped and nibble-paired, shrinking the HBM bin "
        "traffic every histogram pass pays; split decisions and "
        "save_model bytes are bit-identical.",
        group="gbt")
declare("DMLC_COLDSTART_OVERLAP", "1",
        "0 restores the serial cold start: the CUDA kernels of the "
        "boosting loop build (nvcc) and load inline at the first round. "
        "1 (the port) builds and loads them on a thread started by "
        "make_device_data, make_device_data_iter, fit_device and "
        "fit_external, so the build overlaps cuts, binning and upload "
        "(the JAX package overlaps its XLA compiles the same way). "
        "Several ranks stay serial.",
        group="gbt")
declare("DMLC_FEATURE_BUNDLE", "0",
        "1 fuses mutually-exclusive (near-one-hot) feature blocks into "
        "one multi-bin storage feature (LightGBM's EFB with the "
        "most-frequent bin as the default): histograms build on fewer "
        "rows and are exactly unbundled at split evaluation; the "
        "default-bin cell is reconstructed as total - segment, so this "
        "lever is off by default (last-ulp float reassociation).",
        group="gbt")
declare("DMLC_FUSED_ROUND", "auto",
        "The fused round kernel (ops.histogram.fused_round: descend, "
        "left-child accumulation and sibling subtraction of a level, or "
        "a lossguide expansion, in one call). 'auto' and '1' use it "
        "wherever it is eligible (one rank, no DMLC_HIST_BLOCKS, no "
        "missing values; the port has no interpret mode, so '1' forces "
        "nothing more), '0' pins the unfused chain; save_model bytes "
        "identical either way.",
        group="gbt")
declare("DMLC_GROW_POLICY", "depthwise",
        "'lossguide' grows each tree leaf-wise: a gain-priority queue "
        "expands the best open leaf, building ONE histogram per "
        "expansion (sibling subtraction covers the other child) instead "
        "of a whole level at a time; tree structure is identical to "
        "depthwise when the leaf budget is unlimited.",
        group="gbt")
declare("DMLC_HIST_BLOCKS", 0,
        "N>0: the JAX package's deterministic histogram reduction over "
        "N fixed row blocks (rounded up to a power of two >= the "
        "data-axis size), with its checks. The port's int64 fixed-point "
        "sums are order-free, so the blocks change no byte; the knob "
        "turns the fused round off, as in JAX.",
        group="gbt")
declare("DMLC_HIST_QUANT", "0",
        "1 quantizes the multi-chip histogram sync to int8 codes plus "
        "an exact f32 per-column total (the correction term): ~4x fewer "
        "allreduce bytes at n_bins=256, bounded per-cell error "
        "(n_chips*scale/2), EXACT per-(node,feature) grad/hess totals. "
        "No-op on one chip and under DMLC_HIST_BLOCKS.",
        group="gbt")
declare("DMLC_INGEST_CHUNK_ROWS", 2000000,
        "Rows per host-to-device ingest slab of make_device_data's "
        "device route and of the eval set's binning: each slab goes "
        "through pinned memory on a side stream, one slab ahead, and "
        "bins into the uint8 matrix (0 = the whole matrix at once).",
        group="gbt")
declare("DMLC_MAX_LEAVES", 0,
        "Leaf budget per tree under DMLC_GROW_POLICY=lossguide (0 = "
        "unlimited, i.e. up to 2^max_depth); the queue stops after "
        "max_leaves - 1 profitable expansions.",
        group="gbt")
declare("DMLC_TPU_BIN_BACKEND", "",
        "'cpu' forces host-numpy feature binning; empty bins on device.",
        group="gbt")
declare("DMLC_TPU_EXTERNAL_DEVICE_BUDGET", 6442450944,
        "Device-memory budget in bytes of the external-memory engine: "
        "the cached route when the binned rows and their per-row state "
        "fit it (and nothing is sampled), else chunks sized so that one "
        "chunk's bins plus the per-row state fit.",
        group="gbt")
declare("DMLC_TPU_FUSED_DESCEND", "0",
        "1: where the fused round is off, each level's descend runs "
        "inside its histogram pass (the fused descend kernel) instead "
        "of as a pass before it.",
        group="gbt")
declare("DMLC_TPU_ROUNDS_PER_DISPATCH", 25,
        "Boosting rounds a chunk in the dense engine: a chunk's trees "
        "stay on the device and come to the host in one fetch (the JAX "
        "package fuses them into one device dispatch).",
        group="gbt")
declare("DMLC_TPU_SPARSE_ROUNDS_PER_DISPATCH", 8,
        "Rounds a chunk in the sparse engine, whose trees come to the "
        "host together (the JAX package fuses them into one device "
        "dispatch).",
        group="gbt")
declare("DMLC_WARMUP_EXEC", "auto",
        "Whether the cold-start handle also launches each CUDA kernel "
        "of the boosting loop once, on a tiny tensor, after building "
        "and loading them (CUDA loads a kernel's module lazily at its "
        "first launch): 'auto' launches on a CUDA device, '1' "
        "everywhere a kernel can run (the CPU has none), '0' builds and "
        "loads only.",
        group="gbt")

# -- io --------------------------------------------------------------------
declare("DMLC_HDFS_NAMENODE", "",
        "Default namenode host:port for hdfs:// URIs (WebHDFS).",
        group="io")
declare("DMLC_HDFS_USER", "$USER",
        "WebHDFS user.name query parameter.",
        group="io")
declare("DMLC_ITER_PRODUCER_RESTARTS", 0,
        "Process-wide default for ThreadedIter max_restarts (bounded "
        "producer-exception absorption).",
        group="io")

# -- resilience ------------------------------------------------------------
declare("DMLC_CB_RESET_S", 30.0,
        "CircuitBreaker default open-to-half-open probe delay in "
        "seconds.",
        group="resilience")
declare("DMLC_CB_THRESHOLD", 5,
        "CircuitBreaker default consecutive-failure threshold before "
        "opening.",
        group="resilience")
declare("DMLC_CKPT_KEEP", "",
        "How many previous checkpoint versions to retain (.prev chain); "
        "empty = 1.",
        group="resilience")
declare("DMLC_ELASTIC", "0",
        "1 re-shards the surviving workers (shrunk world, re-cut row "
        "shards) once a lost worker's grace lapses; 0 holds the world "
        "for a rejoining replacement.",
        group="resilience")
declare("DMLC_FAULT_INJECT", "",
        "Deterministic fault-injection spec "
        "('point:kind[=v][:p=][:n=][:after=][:at=][:every=],...'); "
        "empty disables.",
        group="resilience")
declare("DMLC_FAULT_SEED", 1234,
        "Seed for the per-rule fault-injection RNG streams.",
        group="resilience")
declare("DMLC_PRODSIM_CHAOS", "",
        "Override chaos schedule for bench.py --prodsim (faultinject "
        "grammar with at=/every= wall-clock triggers); empty derives "
        "the default all-tier schedule from DMLC_PRODSIM_SECONDS.",
        group="resilience")
declare("DMLC_PRODSIM_SECONDS", 24.0,
        "Duration of the bench.py --prodsim production-day simulation "
        "load window in seconds (the chaos schedule scales with it).",
        group="resilience")
declare("DMLC_RECOVERY_DIR", "",
        "Directory for per-rank round-versioned recovery checkpoints "
        "(parallel/recovery); empty requires an explicit recovery_dir=.",
        group="resilience")
declare("DMLC_RECOVERY_STRIDE", 5,
        "Boosting rounds between round-versioned collective checkpoint "
        "commits (the elastic-recovery floor granularity).",
        group="resilience")
declare("DMLC_RETRY_BASE_S", 0.05,
        "RetryPolicy default base backoff seconds (exponential + full "
        "jitter).",
        group="resilience")
declare("DMLC_RETRY_DEADLINE_S", 60.0,
        "RetryPolicy default total-deadline seconds.",
        group="resilience")
declare("DMLC_RETRY_MAX_ATTEMPTS", 4,
        "RetryPolicy default attempt cap.",
        group="resilience")
declare("DMLC_RETRY_MAX_BACKOFF_S", 5.0,
        "RetryPolicy default per-sleep backoff cap in seconds.",
        group="resilience")

# -- serve -----------------------------------------------------------------
declare("DMLC_SERVE_PREWARM", "0",
        "1 runs every batch bucket at ModelRunner construction (serve "
        "cold-start: the kernels' build and the CUDA context).",
        group="serve")

# -- fleet -----------------------------------------------------------------
declare("DMLC_FLEET_FAILOVER", 2,
        "Extra replicas the router tries after the hash-primary fails "
        "(total attempts = 1 + this).",
        group="fleet")
declare("DMLC_FLEET_HEARTBEAT_S", 0.5,
        "Replica load-report (serve_report) interval in seconds.",
        group="fleet")
declare("DMLC_FLEET_MAX_QUEUE", 512,
        "Fleet-wide queued-request bound for router admission control; "
        "beyond it predicts are shed with 503 + Retry-After.",
        group="fleet")
declare("DMLC_FLEET_MAX_REPLICAS", 8,
        "Autoscale ceiling on replica count.",
        group="fleet")
declare("DMLC_FLEET_MIN_REPLICAS", 1,
        "Autoscale floor on replica count.",
        group="fleet")
declare("DMLC_FLEET_PATIENCE", 3,
        "Consecutive out-of-band autoscale observations required before "
        "a recommendation fires (hysteresis).",
        group="fleet")
declare("DMLC_FLEET_PROBE_S", 0.5,
        "Router health-probe / membership-refresh interval in seconds.",
        group="fleet")
declare("DMLC_FLEET_SCALE_IN_S", 0.005,
        "Queue-wait p99 seconds below which the autoscale policy "
        "recommends scale-in.",
        group="fleet")
declare("DMLC_FLEET_SCALE_OUT_S", 0.05,
        "Queue-wait p99 seconds above which the autoscale policy "
        "recommends scale-out.",
        group="fleet")
declare("DMLC_FLEET_VNODES", 64,
        "Virtual nodes per replica on the router's consistent-hash ring "
        "(more = smoother balance, larger ring).",
        group="fleet")
declare("DMLC_FLEET_WAVE_SIZE", 1,
        "Replicas activated per staged-rollout wave.",
        group="fleet")

# -- tenancy ---------------------------------------------------------------
declare("DMLC_TENANT_CLASSES", "",
        "Tenant SLO class map, e.g. 'gold:acme,bar;bronze:baz' — "
        "semicolon-separated class:tenant,... groups.  Unlisted tenants "
        "get DMLC_TENANT_DEFAULT_CLASS.",
        group="tenancy")
declare("DMLC_TENANT_DEFAULT_CLASS", "silver",
        "SLO class assumed for tenants absent from DMLC_TENANT_CLASSES "
        "(gold|silver|bronze).",
        group="tenancy")
declare("DMLC_TENANT_HEDGE_MS", 0,
        "Gold-tenant hedge delay in milliseconds: when > 0 and a second "
        "ring candidate exists, a gold predict still in flight after "
        "this long is raced against the next replica; first success "
        "wins.  0 disables hedging.",
        group="tenancy")
declare("DMLC_TENANT_MAX_INFLIGHT", 64,
        "Router-wide cap on concurrent tenant-tagged predicts; the "
        "overload axis tenant shedding is graded against (bronze shed "
        "at DMLC_TENANT_SHED_FRACTION of it, everyone at it).",
        group="tenancy")
declare("DMLC_TENANT_QUOTA", 0,
        "Per-tenant cap on concurrent in-flight predicts at the router; "
        "beyond it THAT tenant is shed with 429 (no other tenant "
        "notices).  0 = no per-tenant quota.",
        group="tenancy")
declare("DMLC_TENANT_RESIDENT_CAP", 0,
        "Maximum tenant models kept warm (runner resident) per replica; "
        "beyond it the least-recently-served tenant is paged out to its "
        "retained checkpoint bytes and warm-restored on next use. 0 = "
        "unlimited (no paging).",
        group="tenancy")
declare("DMLC_TENANT_SHED_FRACTION", 0.5,
        "Fraction of DMLC_TENANT_MAX_INFLIGHT at which bronze tenants "
        "start shedding with 429 — the 'bronze sheds before gold "
        "queues' contract (doc/serving.md).",
        group="tenancy")

# -- stream ----------------------------------------------------------------
declare("DMLC_STREAM_CHUNK_ROWS", 2048,
        "Fresh event rows gathered per online-trainer refresh.",
        group="stream")
declare("DMLC_STREAM_CURSOR", "",
        "Default cursor checkpoint URI for RecordIOTailer.commit "
        "(crash-safe resume); empty = no default.",
        group="stream")
declare("DMLC_STREAM_DECAY", 1.0,
        "Per-chunk-age sample-weight decay in (0, 1]; 1.0 = pure "
        "sliding window (no weights, warm-start parity).",
        group="stream")
declare("DMLC_STREAM_EVAL_GATE", 0.1,
        "Publisher eval-gate relative tolerance: a refresh is rejected "
        "when holdout score exceeds the active version's by more than "
        "this fraction.",
        group="stream")
declare("DMLC_STREAM_MAX_BACKOFF_S", 1.0,
        "Cap on the tailer's jittered idle-poll backoff in seconds.",
        group="stream")
declare("DMLC_STREAM_POLL_S", 0.05,
        "Tailer base poll interval in seconds; idle polls back off "
        "exponentially (with jitter) from here.",
        group="stream")
declare("DMLC_STREAM_WINDOW_CHUNKS", 4,
        "Sliding training window length in chunks; steady-state window "
        "row count (and compiled shapes) stay fixed once full.",
        group="stream")

# -- distributed -----------------------------------------------------------
declare("DMLC_KVSTORE_CHECK", 0,
        "1 cross-checks that every worker pulled the same KVStore key "
        "batch before the fused dist_sync reduction (debug).",
        group="distributed")
declare("DMLC_LEGACY_TRACKER_PORT", "",
        "Port of the legacy one-shot tracker protocol (elastic-recovery "
        "example ABI).",
        group="distributed")
declare("DMLC_NUM_ATTEMPT", 0,
        "Restart attempt number of this task (elastic recovery).",
        group="distributed")
declare("DMLC_NUM_SERVER", 0,
        "Parameter-server count (PS ABI only; the engine itself is the "
        "KVStore shim).",
        group="distributed")
declare("DMLC_NUM_WORKER", 1,
        "Worker count the tracker coordinates.",
        group="distributed")
declare("DMLC_PS_ROOT_PORT", "",
        "PS scheduler port (PSTracker env ABI).",
        group="distributed")
declare("DMLC_PS_ROOT_URI", "",
        "PS scheduler host (PSTracker env ABI).",
        group="distributed")
declare("DMLC_ROLE", "worker",
        "Process role in a distributed job: worker / server / "
        "scheduler.",
        group="distributed")
declare("DMLC_TASK_ID", 0,
        "This worker's task index within the job.",
        group="distributed")
declare("DMLC_TRACKER_GRACE_S", 0.0,
        "Reconnect grace window in seconds before a lost persistent "
        "worker is declared dead.",
        group="distributed")
declare("DMLC_TRACKER_PORT", "",
        "Tracker TCP port.",
        group="distributed")
declare("DMLC_TRACKER_URI", "",
        "Tracker host the worker handshakes with.",
        group="distributed")
declare("DMLC_WORKDIR", "",
        "Remote working directory launchers cd into before exec'ing the "
        "worker command.",
        group="distributed")

# -- launch ----------------------------------------------------------------
declare("DMLC_LAUNCH_GRACEFUL_S", 5.0,
        "Teardown grace in seconds between SIGTERM and SIGKILL when a "
        "JobSet shuts its workers down.",
        group="launch")
declare("DMLC_LAUNCH_LOG_DIR", "",
        "Directory for per-worker launch log files; empty uses a fresh "
        "temp dir per transport.",
        group="launch")
declare("DMLC_LAUNCH_MONITOR_S", 0.2,
        "JobSet supervisor poll interval in seconds (liveness poll, "
        "respawn scheduling, tracker cross-check).",
        group="launch")
declare("DMLC_LAUNCH_RESTART_LIMIT", 2,
        "Per-rank respawn budget for a supervised JobSet (spawn "
        "failures and unexpected exits both consume it; 0 disables "
        "restarts).",
        group="launch")
declare("DMLC_LAUNCH_WEDGE_CYCLES", 25,
        "Consecutive monitor cycles a rank may stay process-alive but "
        "tracker-lost before the JobSet declares it wedged and kills it "
        "for respawn.",
        group="launch")
declare("DMLC_LAUNCH_SPOOL", "",
        "Directory where each process of the port that exits cleanly "
        "leaves its kernel launch counts (launches-<pid>.json, "
        "ops.histogram.launch_counts): how a parent counts the kernels "
        "its children launched; empty disables. The port's own knob.",
        group="launch")

# -- ps --------------------------------------------------------------------
declare("DMLC_PS_PIPELINE", 8,
        "In-flight request window per server connection: async pushes "
        "beyond this many unacked requests block the sender.",
        group="ps")
declare("DMLC_PS_PULL_TIMEOUT_S", 60.0,
        "Seconds a pull may wait on the server-side staleness gate "
        "before erroring out.",
        group="ps")
declare("DMLC_PS_RECONNECT_S", 30.0,
        "Deadline in seconds for re-resolving and re-dialing a lost "
        "server connection (respawn failover window).",
        group="ps")
declare("DMLC_PS_SERVER_ID", -1,
        "Server shard id for DMLC_ROLE=server processes; -1 lets the "
        "scheduler assign the next free id (a respawn passes its old id "
        "to reclaim the shard).",
        group="ps")
declare("DMLC_PS_SERVER_URI", "127.0.0.1",
        "Host/interface a DMLC_ROLE=server process binds its data plane "
        "to (advertised to the scheduler).",
        group="ps")
declare("DMLC_PS_SNAPSHOT_DIR", "",
        "Directory for per-server shard snapshots (atomic CRC'd "
        "checkpoints); empty disables durability.",
        group="ps")
declare("DMLC_PS_SNAPSHOT_STRIDE", 0,
        "Committed clock ticks between shard snapshots; 0 disables "
        "periodic snapshots.",
        group="ps")
declare("DMLC_PS_STALENESS", 4,
        "Bounded-staleness window tau for dist_async pulls: a pull at "
        "worker clock c blocks until every worker committed c - tau; 0 "
        "= BSP, negative = fully async (never block).",
        group="ps")
