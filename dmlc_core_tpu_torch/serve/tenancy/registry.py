"""Tenant-namespaced model registry with LRU paging of warm runners.

Many models, one fleet (doc/serving.md, "Multi-tenant serving"): each
tenant gets its own monotone version counter, its own retained version
history and its own atomically swappable current pointer — a rollback
for tenant A is invisible to tenant B by construction, because the only
shared state is the residency budget.

Layering on ``serve/registry.py``: a tenant version is retained as the
model's ``save_model`` BYTES (``model_to_bytes`` — the exact payload
``checkpoint_model`` embeds), not as a live runner.  Only the *current*
version of a tenant ever holds a :class:`ModelRunner`, and even that is
droppable: when resident runners exceed ``DMLC_TENANT_RESIDENT_CAP``,
the least-recently-served tenant is paged out (runner dropped, bytes
kept) and transparently rebuilt on its next request.  The rebuild goes
``model_from_bytes`` -> new runner -> :meth:`ModelRunner.warmup`, so a
page-in re-executes the pow-2 bucket ladder, and predictions after a
restore are bit-identical to before the eviction (same bytes, same
kernels).

Concurrency: per-tenant current pointers are immutable tuples read
lock-free (the ModelRegistry ``_current`` idiom, one atomic reference
fetch); all mutation (publish, activate, LRU bookkeeping, eviction)
holds the registry lock.  A page-in builds its runner OUTSIDE that lock
— one tenant's cold start must not stall every other tenant's resolve —
serialized per tenant by a dedicated restore lock.

The PyTorch port's counterpart of
``dmlc_core_tpu/serve/tenancy/registry.py``.  The port compiles nothing
per shape (``serve/runner.py``), so a page-in has no compile cache to
deserialise: its warmup runs the bucket ladder through the model's
predict — on a card, one ``forest_kernel`` launch a bucket.
:class:`TenantRegistry` takes ``device=`` (``None``: ``cuda``) and puts
every model it rebuilds from bytes there; paging a tenant out drops its
runner and its model, and with them the model's tensors on the card.
:func:`load_tenant_checkpoint` takes ``device=`` the same way.  The
tenant checkpoint is the JAX package's file: either package loads the
other's.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.parameter import get_env
from dmlc_core_tpu_torch.base.racecheck import instrument_class
from dmlc_core_tpu_torch.base.timer import get_time
from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint, load_checkpoint
from dmlc_core_tpu_torch.serve.registry import model_from_bytes, model_to_bytes
from dmlc_core_tpu_torch.serve.runner import ModelRunner
from dmlc_core_tpu_torch.serve.tenancy.instruments import tenant_metrics

__all__ = ["TenantRegistry", "checkpoint_tenant_model",
           "load_tenant_checkpoint"]

#: the ``like`` structure of a tenant model checkpoint: the model's
#: opaque byte leaf plus the utf-8 tenant name it belongs to
_TLIKE = {"model": np.zeros(0, np.uint8), "tenant": np.zeros(0, np.uint8)}


def checkpoint_tenant_model(uri: str, tenant: str, model: Any,
                            version: int) -> None:
    """Write ``model`` to ``uri`` as a ``(tenant, version)`` serving
    checkpoint — ``checkpoint_model`` plus an embedded tenant name, so
    a staged fleet rollout can verify the payload lands in the
    namespace it was cut for."""
    CHECK(version >= 1, f"model versions start at 1, got {version}")
    CHECK(bool(tenant), "checkpoint_tenant_model: empty tenant name")
    checkpoint(uri, {
        "model": np.frombuffer(model_to_bytes(model), np.uint8),
        "tenant": np.frombuffer(tenant.encode("utf-8"), np.uint8),
    }, version=version)


def load_tenant_checkpoint(uri: str, device: Any = None
                           ) -> Tuple[str, int, Optional[Any]]:
    """Inverse of :func:`checkpoint_tenant_model`:
    ``(tenant, version, model)``, or ``("", 0, None)`` when no
    checkpoint exists.  The model lands on ``device`` (``None``:
    ``cuda``)."""
    version, state = load_checkpoint(uri, _TLIKE)
    if version == 0 and state is _TLIKE:
        return "", 0, None
    tenant = np.asarray(state["tenant"]).tobytes().decode("utf-8")
    return tenant, version, model_from_bytes(
        np.asarray(state["model"]).tobytes(), device)


class _Tenant:
    """Mutable per-tenant record; guarded by the owning registry's lock
    except for ``current`` (immutable tuple, read lock-free)."""

    __slots__ = ("name", "blobs", "current", "tick", "restore_lock")

    def __init__(self, name: str):
        self.name = name
        #: version -> retained save_model bytes (the paging source of
        #: truth; never dropped while the tenant exists)
        self.blobs: Dict[int, bytes] = {}
        #: (version, runner-or-None): runner None == paged out.  The
        #: tuple is swapped whole so a lock-free reader can never see a
        #: version/runner mismatch.
        self.current: Optional[Tuple[int, Optional[ModelRunner]]] = None
        #: LRU clock value of the last resolve
        self.tick: int = 0
        #: serializes page-ins for THIS tenant only
        self.restore_lock = threading.Lock()


@instrument_class
class TenantRegistry:
    """Per-tenant versioned models behind one residency budget.

    ``runner_opts`` (``max_batch``, ``min_bucket``) apply to every
    tenant so all resident runners share one batch-bucket ladder — the
    set of executed shapes stays bounded by the ladder, not by the
    tenant count.  ``device`` is where every model rebuilt from bytes
    lives (``None``: ``cuda``)."""

    #: per-tenant ``current`` tuples are read lock-free BY DESIGN (the
    #: ModelRegistry ``_current`` idiom applied per namespace); the
    #: ``_Tenant`` record itself is plain data, so the exemption is on
    #: the map that reaches it
    _racecheck_exempt = frozenset({"_tenants"})

    def __init__(self, resident_cap: Optional[int] = None,
                 device: Any = None, **runner_opts: Any):
        if resident_cap is None:
            resident_cap = get_env("DMLC_TENANT_RESIDENT_CAP", 0, int)
        CHECK(resident_cap >= 0,
              f"resident_cap must be >= 0, got {resident_cap}")
        self.resident_cap = resident_cap
        self.device = device
        self._runner_opts = dict(runner_opts)
        self._lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}
        self._clock = 0
        self.evictions = 0
        self.restores = 0

    # -- internal ---------------------------------------------------------
    def _tenant_locked(self, tenant: str, create: bool) -> _Tenant:
        CHECK(bool(tenant), "tenant name must be non-empty")
        t = self._tenants.get(tenant)
        if t is None:
            if not create:
                raise KeyError(f"unknown tenant {tenant!r}")
            t = self._tenants[tenant] = _Tenant(tenant)
        return t

    def _build_runner(self, tenant: str, blob: bytes,
                      warm: bool) -> ModelRunner:
        """Rebuild a runner from retained bytes on the registry's
        device; ``warm`` runs the ladder warmup and records restore
        evidence.  Called OUTSIDE the registry lock."""
        t0 = get_time()
        runner = ModelRunner(model_from_bytes(blob, self.device),
                             name=tenant,
                             **self._runner_opts)
        if warm and runner.n_features:
            runner.warmup()
        wall = get_time() - t0
        if warm:
            if _metrics.enabled():
                tenant_metrics()["restore"].observe(wall, tenant=tenant)
            LOG("INFO", "serve.tenancy %s: warm-restored in %.3fs",
                tenant, wall)
        return runner

    def _evict_over_cap_locked(self) -> None:
        """Page out least-recently-served tenants until the resident
        count fits the cap.  Lock held; pure pointer drops."""
        if not self.resident_cap:
            return
        while True:
            resident = [t for t in self._tenants.values()
                        if t.current is not None and t.current[1] is not None]
            if len(resident) <= self.resident_cap:
                break
            victim = min(resident, key=lambda t: t.tick)
            victim.current = (victim.current[0], None)  # runner dropped
            self.evictions += 1
            if _metrics.enabled():
                tenant_metrics()["evictions"].inc(1, tenant=victim.name)
            LOG("INFO", "serve.tenancy %s: paged out v%d "
                "(resident %d > cap %d)", victim.name, victim.current[0],
                len(resident), self.resident_cap)

    def _set_resident_gauge_locked(self) -> None:
        if _metrics.enabled():
            tenant_metrics()["resident"].set(sum(
                1 for t in self._tenants.values()
                if t.current is not None and t.current[1] is not None))

    # -- publication ------------------------------------------------------
    def publish(self, tenant: str, model: Any,
                version: Optional[int] = None, source: Optional[str] = None,
                activate: bool = True) -> int:
        """Register ``model`` under ``tenant`` and (by default) make it
        that tenant's current.  ``version=None`` auto-increments the
        TENANT's counter; an explicit version must exceed every version
        that tenant has published — other tenants' counters are
        irrelevant.  ``activate=False`` stages bytes only (no runner is
        built, so staging a fleet-wide rollout costs no residency)."""
        blob = model_to_bytes(model)
        runner = (self._build_runner(tenant, blob, warm=False)
                  if activate else None)
        with self._lock:
            t = self._tenant_locked(tenant, create=True)
            last = max(t.blobs) if t.blobs else 0
            if version is None:
                version = last + 1
            CHECK(version > last,
                  f"tenant {tenant!r}: version {version} is not monotonic "
                  f"(latest published is {last})")
            t.blobs[version] = blob
            if activate:
                self._clock += 1
                t.tick = self._clock
                t.current = (version, runner)       # THE atomic swap
                self._evict_over_cap_locked()
            self._set_resident_gauge_locked()
        LOG("INFO", "serve.tenancy %s: %s v%d (%s)%s", tenant,
            "published" if activate else "staged", version,
            type(model).__name__, f" from {source}" if source else "")
        if _metrics.enabled():
            tenant_metrics()["published"].inc(1, tenant=tenant)
        return version

    def load(self, tenant: str, uri: str, activate: bool = True) -> int:
        """Load a ``(tenant, version)`` checkpoint from any Stream URI
        and publish it under ``tenant``.  The checkpoint's embedded
        tenant name must match — a payload cut for one namespace cannot
        land in another."""
        ck_tenant, version, model = load_tenant_checkpoint(uri, "cpu")
        CHECK(model is not None, f"no tenant model checkpoint at {uri}")
        CHECK(ck_tenant == tenant,
              f"tenant checkpoint at {uri} belongs to {ck_tenant!r}, "
              f"not {tenant!r}")
        return self.publish(tenant, model, version=version, source=uri,
                            activate=activate)

    def save(self, tenant: str, uri: str,
             version: Optional[int] = None) -> None:
        """Checkpoint a tenant's retained version (default: current)."""
        with self._lock:
            t = self._tenant_locked(tenant, create=False)
            if version is None:
                CHECK(t.current is not None,
                      f"tenant {tenant!r}: no version activated")
                version = t.current[0]
            blob = t.blobs[version]
        checkpoint_tenant_model(uri, tenant,
                                model_from_bytes(blob, "cpu"), version)

    def activate(self, tenant: str, version: int) -> None:
        """Point ``tenant``'s current at an already-retained version
        (rollback).  Rebuilds the runner from retained bytes — so a
        rollback is also a restore — and touches NO other tenant's
        pointer."""
        with self._lock:
            t = self._tenant_locked(tenant, create=False)
            CHECK(version in t.blobs,
                  f"tenant {tenant!r}: unknown version {version}")
            blob = t.blobs[version]
        runner = self._build_runner(tenant, blob, warm=False)
        with self._lock:
            self._clock += 1
            t.tick = self._clock
            t.current = (version, runner)
            self._evict_over_cap_locked()
            self._set_resident_gauge_locked()
        LOG("INFO", "serve.tenancy %s: activated v%d", tenant, version)

    # -- resolution -------------------------------------------------------
    def current(self, tenant: str) -> Tuple[int, ModelRunner]:
        """The ``(version, runner)`` pair to execute ``tenant``'s rows
        on, paging the runner back in if it was evicted.  The resident
        fast path reads the immutable current tuple lock-free and only
        takes the lock for the LRU touch."""
        t = self._tenants.get(tenant)  # dmlcheck: off:lock-discipline
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        cur = t.current
        CHECK(cur is not None, f"tenant {tenant!r}: no model published")
        version, runner = cur
        if runner is not None:
            with self._lock:
                self._clock += 1
                t.tick = self._clock
            return version, runner
        # paged out: rebuild outside the registry lock, serialized per
        # tenant (a second waiter reuses the first's runner)
        with t.restore_lock:
            cur = t.current
            CHECK(cur is not None,
                  f"tenant {tenant!r}: no model published")
            version, runner = cur
            if runner is None:
                with self._lock:
                    blob = t.blobs[version]
                runner = self._build_runner(tenant, blob, warm=True)
                with self._lock:
                    self._clock += 1
                    t.tick = self._clock
                    t.current = (version, runner)
                    self.restores += 1
                    self._evict_over_cap_locked()
                    self._set_resident_gauge_locked()
        return version, runner

    def current_version(self, tenant: str) -> Optional[int]:
        """Current version for ``tenant`` (None before first activate;
        KeyError for an unknown tenant)."""
        t = self._tenants.get(tenant)  # dmlcheck: off:lock-discipline
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        cur = t.current
        return None if cur is None else cur[0]

    def versions(self, tenant: str) -> List[int]:
        """All retained versions for ``tenant``, ascending."""
        with self._lock:
            return sorted(self._tenant_locked(tenant, create=False).blobs)

    def tenants(self) -> List[str]:
        """All tenant names, sorted."""
        with self._lock:
            return sorted(self._tenants)

    def resident(self) -> List[str]:
        """Tenants whose current runner is warm right now, sorted."""
        with self._lock:
            return sorted(t.name for t in self._tenants.values()
                          if t.current is not None
                          and t.current[1] is not None)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Health-doc shaped view: tenant -> {version, resident} — what
        a replica heartbeats to the tracker and /healthz exposes for
        the tenant rollout gate."""
        with self._lock:
            return {name: {
                "version": None if t.current is None else t.current[0],
                "resident": (t.current is not None
                             and t.current[1] is not None),
            } for name, t in self._tenants.items()}
