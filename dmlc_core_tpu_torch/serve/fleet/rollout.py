"""Staged fleet rollouts: publish-everywhere, activate in waves,
roll back on regression.

The registry hot-swap contract (``doc/serving.md``) already makes a
SINGLE replica's version switch atomic and zero-drop; this module
lifts that to the fleet:

1. **Stage** — ``publish(activate=False)`` the new checkpoint on every
   replica (``POST /admin/load``).  Model bytes land and runners warm
   while 100% of traffic still runs the old version; monotone version
   discipline holds per replica.
2. **Waves** — activate ``DMLC_FLEET_WAVE_SIZE`` replicas at a time
   (``POST /admin/activate``).  In-flight batches finish on the old
   version (the runner reference they already resolved); the router
   keeps routing — mid-rollout the fleet intentionally serves BOTH
   versions, which is observable per response (``"version"``) and in
   ``serve_version_requests_total``.
3. **Gate** — after each wave every just-activated replica must probe
   healthy on the new version, and the optional ``eval_gate`` callback
   (e.g. a canary scoring a holdout through the router, the
   ``stream.ModelPublisher`` eval-gate idea at fleet scope) must
   assent.  A failed gate triggers **rollback**: every replica
   activated so far flips back to its old version — same atomic
   ``activate`` path, so rollback is as zero-drop as rollout.

The wave/rollback decision logic is a pure state machine
(:class:`RolloutController`) driven through a thin transport
(:class:`FleetAdmin` / :class:`HttpFleetAdmin`), so the policy is
testable without sockets and the transport without policy.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/fleet/rollout.py``:
the same names, env ABI and metric names.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.resilience import RetryPolicy
from dmlc_core_tpu_torch.io.http_util import http_request
from dmlc_core_tpu_torch.serve.fleet.instruments import fleet_metrics

__all__ = ["plan_waves", "RolloutController", "FleetAdmin",
           "HttpFleetAdmin", "Rollout"]


def plan_waves(replicas: Sequence[int], wave_size: int) -> List[List[int]]:
    """Partition ``replicas`` (in order) into activation waves of
    ``wave_size`` — the last wave may be short.  Pure."""
    CHECK(wave_size >= 1, f"wave_size must be >= 1, got {wave_size}")
    ids = list(replicas)
    return [ids[i:i + wave_size] for i in range(0, len(ids), wave_size)]


class RolloutController:
    """Pure wave/rollback state machine (no I/O, no clocks).

    Drive it: :meth:`next_wave` → activate those replicas however you
    like → report :meth:`wave_ok` / :meth:`wave_failed`.  After a
    failure, :attr:`rollback_targets` lists every replica activated so
    far (including the failed wave — its members may have switched
    before the gate tripped) in reverse-activation order.
    """

    STAGING, ACTIVATING, DONE, ROLLED_BACK = (
        "staging", "activating", "done", "rolled_back")

    def __init__(self, replicas: Sequence[int], wave_size: int):
        self.waves = plan_waves(replicas, wave_size)
        self.state = self.STAGING
        self.activated: List[int] = []
        self._wave_i = 0

    def staged(self) -> None:
        """All replicas hold the staged version; activation may begin."""
        CHECK(self.state == self.STAGING,
              f"staged() in state {self.state}")
        self.state = self.ACTIVATING

    def next_wave(self) -> Optional[List[int]]:
        """Replicas to activate next, or None when the rollout is
        complete (state is/moves to DONE)."""
        if self.state == self.DONE:
            return None
        CHECK(self.state == self.ACTIVATING,
              f"next_wave() in state {self.state}")
        if self._wave_i >= len(self.waves):
            self.state = self.DONE
            return None
        return list(self.waves[self._wave_i])

    def wave_ok(self) -> None:
        """The current wave passed its health/eval gate."""
        CHECK(self.state == self.ACTIVATING,
              f"wave_ok() in state {self.state}")
        self.activated.extend(self.waves[self._wave_i])
        self._wave_i += 1
        if self._wave_i >= len(self.waves):
            self.state = self.DONE

    def wave_failed(self) -> List[int]:
        """The current wave regressed → ROLLED_BACK; returns
        :attr:`rollback_targets`."""
        CHECK(self.state == self.ACTIVATING,
              f"wave_failed() in state {self.state}")
        self.activated.extend(self.waves[self._wave_i])
        self.state = self.ROLLED_BACK
        return self.rollback_targets

    @property
    def rollback_targets(self) -> List[int]:
        """Replicas to flip back, most recently activated first."""
        return list(reversed(self.activated))


class FleetAdmin:
    """Transport interface the rollout driver speaks — implement these
    four against any control plane (HTTP here; a test fake in
    ``tests/test_fleet.py``)."""

    def replicas(self) -> Dict[int, str]:
        """rank → addressable endpoint."""
        raise NotImplementedError

    def load(self, rank: int, uri: str, activate: bool = False,
             tenant: Optional[str] = None) -> int:
        """Publish checkpoint ``uri`` on ``rank`` (within ``tenant``'s
        namespace when given); returns the version."""
        raise NotImplementedError

    def activate(self, rank: int, version: int,
                 tenant: Optional[str] = None) -> None:
        """Switch ``rank``'s traffic to a retained ``version`` (within
        ``tenant``'s namespace when given)."""
        raise NotImplementedError

    def health(self, rank: int) -> Dict[str, Any]:
        """``rank``'s health document (``status``, ``version``, ...)."""
        raise NotImplementedError


class HttpFleetAdmin(FleetAdmin):
    """FleetAdmin over the replica admin HTTP surface.  ``endpoints``
    is a rank → base-URL map (e.g. ``tracker.serve_endpoints()``)."""

    def __init__(self, endpoints: Dict[int, str],
                 policy: Optional[RetryPolicy] = None):
        self._endpoints = dict(endpoints)
        self._policy = policy if policy is not None else RetryPolicy.from_env()

    def _post(self, rank: int, path: str, payload: Dict[str, Any]
              ) -> Dict[str, Any]:
        _, _, body = http_request(
            "POST", self._endpoints[rank] + path, None,
            json.dumps(payload).encode(), ok=(200,), retry=self._policy,
            idempotent=True, op="fleet_admin")
        return json.loads(body)

    def replicas(self) -> Dict[int, str]:
        return dict(self._endpoints)

    def load(self, rank: int, uri: str, activate: bool = False,
             tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return int(self._post(
                rank, "/admin/tenant/load",
                {"tenant": tenant, "uri": uri,
                 "activate": activate})["version"])
        return int(self._post(rank, "/admin/load",
                              {"uri": uri, "activate": activate})["version"])

    def activate(self, rank: int, version: int,
                 tenant: Optional[str] = None) -> None:
        if tenant is not None:
            self._post(rank, "/admin/tenant/activate",
                       {"tenant": tenant, "version": version})
            return
        self._post(rank, "/admin/activate", {"version": version})

    def health(self, rank: int) -> Dict[str, Any]:
        _, _, body = http_request(
            "GET", self._endpoints[rank] + "/healthz",
            retry=self._policy, op="fleet_admin")
        return json.loads(body)


class Rollout:
    """Staged rollout driver over a :class:`FleetAdmin`.

    ``eval_gate`` (optional) is called once per wave AFTER its health
    checks pass, with the target version; returning False (or raising)
    rolls the fleet back.  ``settle_s`` is the pause between a wave's
    activation and its gate — long enough for a health probe and a few
    batches of traffic on the new version.
    """

    def __init__(self, admin: FleetAdmin,
                 wave_size: Optional[int] = None,
                 eval_gate: Optional[Callable[[int], bool]] = None,
                 settle_s: float = 0.2, tenant: Optional[str] = None):
        self.admin = admin
        self.wave_size = (wave_size if wave_size is not None else
                          int(os.environ.get("DMLC_FLEET_WAVE_SIZE", "1")))
        self.eval_gate = eval_gate
        self.settle_s = settle_s
        #: tenant-scoped rollout: stage/activate/gate/rollback all act
        #: on ONE tenant's namespace — every other tenant's current
        #: pointer is untouched by construction (doc/serving.md)
        self.tenant = tenant

    def _doc_version(self, doc: Dict[str, Any]) -> Optional[int]:
        if self.tenant is None:
            return doc.get("version")
        return (doc.get("tenants") or {}).get(self.tenant,
                                              {}).get("version")

    def _load(self, rank: int, uri: str) -> int:
        if self.tenant is None:
            return self.admin.load(rank, uri, activate=False)
        return self.admin.load(rank, uri, activate=False,
                               tenant=self.tenant)

    def _activate(self, rank: int, version: int) -> None:
        if self.tenant is None:
            self.admin.activate(rank, version)
        else:
            self.admin.activate(rank, version, tenant=self.tenant)

    def run(self, uri: str) -> Dict[str, Any]:
        """Deploy checkpoint ``uri`` fleet-wide; returns a report dict
        (``outcome`` ∈ activated|rolled_back, per-wave detail)."""
        endpoints = self.admin.replicas()
        ranks = sorted(endpoints)
        CHECK(ranks, "rollout over an empty fleet")
        old: Dict[int, Optional[int]] = {
            r: self._doc_version(self.admin.health(r)) for r in ranks}
        version = 0
        for r in ranks:                       # stage everywhere first
            version = self._load(r, uri)
        if _metrics.enabled():
            fleet_metrics()["rollout_target"].set(version)
        LOG("INFO", "fleet.rollout: v%d staged on %d replicas "
            "(wave size %d)%s", version, len(ranks), self.wave_size,
            f" for tenant {self.tenant!r}" if self.tenant else "")
        ctrl = RolloutController(ranks, self.wave_size)
        ctrl.staged()
        report: Dict[str, Any] = {"version": version, "replicas": ranks,
                                  "waves": [], "outcome": None}
        while True:
            wave = ctrl.next_wave()
            if wave is None:
                report["outcome"] = "activated"
                break
            for r in wave:
                self._activate(r, version)
            time.sleep(self.settle_s)
            ok = self._gate(wave, version)
            report["waves"].append({"replicas": wave, "ok": ok})
            if _metrics.enabled():
                fleet_metrics()["rollout_waves"].inc(
                    1, outcome="activated" if ok else "rolled_back")
            if ok:
                ctrl.wave_ok()
                continue
            targets = ctrl.wave_failed()
            for r in targets:
                if old[r] is not None:
                    self._activate(r, old[r])
            report["outcome"] = "rolled_back"
            report["rolled_back"] = targets
            if self.tenant is not None and _metrics.enabled():
                from dmlc_core_tpu_torch.serve.tenancy.instruments import \
                    tenant_metrics
                tenant_metrics()["rollbacks"].inc(1, tenant=self.tenant)
            LOG("WARNING", "fleet.rollout: v%d regressed — rolled %d "
                "replicas back%s", version, len(targets),
                f" for tenant {self.tenant!r}" if self.tenant else "")
            break
        return report

    def _gate(self, wave: List[int], version: int) -> bool:
        for r in wave:
            try:
                doc = self.admin.health(r)
            except Exception:  # noqa: BLE001 — unreachable == regressed
                return False
            if doc.get("status") != "ok":
                return False
            if self._doc_version(doc) != version:
                return False
        if self.eval_gate is not None:
            try:
                return bool(self.eval_gate(version))
            except Exception:  # noqa: BLE001 — a crashing gate must fail
                return False   # closed, not promote a bad version
        return True
