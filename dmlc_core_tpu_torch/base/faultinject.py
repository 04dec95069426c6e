"""Deterministic, seed-driven fault injection — failure as a testable input.

Nothing in a distributed stack is trustworthy until it has been watched
surviving faults; this module makes faults a first-class, reproducible
input instead of an ops anecdote.  Production code declares **named
injection points** (``http``, ``stream``, ``checkpoint``, ``iter``,
``serve``…) by calling :func:`check` at the place a real-world failure
would land; with no spec configured that call is a few dict/env lookups
and returns ``None`` — the no-chaos path stays the production path.

Spec grammar (``DMLC_FAULT_INJECT`` or :class:`inject`)::

    spec  := rule ("," rule)*
    rule  := point ":" kind ["=" value] (":" opt)*
    opt   := "p=" float        # fire probability per check (default 1)
           | "n=" int          # max fires for this rule (default unlimited)
           | "after=" int      # skip the first k checks (default 0)
           | "at=" float       # eligible once >= at seconds have elapsed
           | "every=" float    # wave trigger: at most one draw per
                               #   every-second wave (wave k spans
                               #   [at + k*every, at + (k+1)*every))

Examples::

    DMLC_FAULT_INJECT="http:error=503:p=0.3,stream:truncate:p=0.1"
    DMLC_FAULT_INJECT="checkpoint:kill:after=1"   # 2nd checkpoint dies
    DMLC_FAULT_INJECT="worker:kill:after=7"       # SIGKILL at round 8
    DMLC_FAULT_INJECT="allreduce:abort:after=30"  # void the round
    DMLC_FAULT_INJECT="prodsim_replica:kill:at=5:n=1"   # T+5s, once
    DMLC_FAULT_INJECT="launch_host:wave=0.3:at=10:n=1"  # spot wave T+10s
    with faultinject.inject("serve:error=503:p=0.5:n=20"): ...

Wall-clock triggers (the **chaos scheduler**): ``at=`` makes a rule
eligible only once the schedule clock has advanced past that many
seconds since :func:`configure` (re)anchored the epoch; ``every=``
partitions elapsed time into waves and allows at most ONE probability
draw per wave, so ``launch_host:wave=0.3:every=30:p=0.5`` models a
spot-preemption front that may (seed-deterministically) sweep the
cluster every 30 s.  The schedule clock defaults to
``time.monotonic`` and is injectable via :func:`set_clock`, so tests
drive waves with a fake clock and the whole schedule — which waves
fire, in which order — is a pure function of (spec, seed, clock),
asserted in ``tests/test_resilience.py``.

Kinds are interpreted by the injection SITE (the injector only decides
*whether* to fire): ``error=<status>`` fabricates an HTTP failure,
``reset`` a connection reset, ``truncate`` a short ranged-read body,
``kill`` a SIGKILL of the current process (mid-checkpoint at the
``checkpoint`` point, mid-boost at the ``worker`` point — the elastic
chaos drill's trigger — or mid-collective at ``allreduce``), ``abort``
an in-flight abort (IOError mid-checkpoint; at ``allreduce`` it voids
the epoch on EVERY worker — the all-or-nothing round drill), ``corrupt``
a post-commit byte flip, plain ``error`` a producer exception.  The
``worker`` point is checked once per boosting round and at each commit,
so ``worker:kill:after=N`` dies at a deterministic, seed-reproducible
round.  See ``doc/robustness.md`` for the per-point table.

Determinism: each rule draws from its own ``random.Random`` seeded by
``DMLC_FAULT_SEED`` (default 1234) and the rule's index, so a given
call sequence fires the identical faults run after run.  Every fire is
counted in ``dmlc_faults_injected_total{point,kind}`` — a chaos run
that injected nothing is a configuration bug, and the counter is the
evidence either way.

This package's own copy of ``dmlc_core_tpu.base.faultinject`` (the hook
``io.threaded_iter`` checks).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dmlc_core_tpu_torch.base import metrics as _metrics

__all__ = ["Fault", "check", "configure", "inject", "active",
           "fired_total", "stats", "rules", "set_clock"]

_ENV_SPEC = "DMLC_FAULT_INJECT"
_ENV_SEED = "DMLC_FAULT_SEED"
_DEFAULT_SEED = 1234


class Fault:
    """One fired fault: the injection point, the kind, and an optional
    value (``error=503`` → kind ``"error"``, value ``"503"``)."""

    __slots__ = ("point", "kind", "value")

    def __init__(self, point: str, kind: str, value: Optional[str] = None):
        self.point = point
        self.kind = kind
        self.value = value

    def int_value(self, default: int) -> int:
        """The value as an int (``default`` when absent/garbled)."""
        try:
            return int(self.value) if self.value else default
        except ValueError:
            return default

    def __repr__(self) -> str:
        v = f"={self.value}" if self.value is not None else ""
        return f"Fault({self.point}:{self.kind}{v})"


class _Rule:
    __slots__ = ("point", "kind", "value", "p", "n", "after",
                 "at", "every", "last_wave", "checked", "fires", "rng")

    def __init__(self, point: str, kind: str, value: Optional[str],
                 p: float, n: Optional[int], after: int, seed: int,
                 at: Optional[float] = None,
                 every: Optional[float] = None):
        self.point = point
        self.kind = kind
        self.value = value
        self.p = p
        self.n = n
        self.after = after
        self.at = at
        self.every = every
        self.last_wave = -1       # highest wave index already drawn for
        self.checked = 0
        self.fires = 0
        self.rng = random.Random(seed)


def _parse(spec: str, seed: int) -> List[_Rule]:
    rules: List[_Rule] = []
    for idx, raw in enumerate(s for s in spec.split(",") if s.strip()):
        fields = [f.strip() for f in raw.strip().split(":")]
        if len(fields) < 2:
            raise ValueError(
                f"fault spec rule {raw!r}: want point:kind[...], "
                f"see doc/robustness.md")
        point = fields[0]
        kind, value = fields[1], None
        if "=" in kind:
            kind, value = kind.split("=", 1)
        p, n, after, at, every = 1.0, None, 0, None, None
        for opt in fields[2:]:
            k, _, v = opt.partition("=")
            if k == "p":
                p = float(v)
            elif k == "n":
                n = int(v)
            elif k == "after":
                after = int(v)
            elif k == "at":
                at = float(v)
                if at < 0:
                    raise ValueError(
                        f"fault spec rule {raw!r}: at= must be >= 0")
            elif k == "every":
                every = float(v)
                if every <= 0:
                    raise ValueError(
                        f"fault spec rule {raw!r}: every= must be > 0")
            else:
                raise ValueError(
                    f"fault spec rule {raw!r}: unknown option {opt!r}")
        rules.append(_Rule(point, kind, value, p, n, after,
                           seed=seed * 1000003 + idx, at=at, every=every))
    return rules


_LOCK = threading.Lock()
_RULES: List[_Rule] = []
_CONFIGURED_SPEC: Optional[str] = None  # spec the rules were parsed from
_PINNED = 0                             # >0: inject() overrides the env
_CLOCK: Callable[[], float] = time.monotonic  # schedule clock (injectable)
_EPOCH = 0.0                            # clock value when configure() ran
_FM = None


def set_clock(clock: Optional[Callable[[], float]] = None) -> None:
    """Install the schedule clock ``at=``/``every=`` rules are timed
    against (``None`` restores ``time.monotonic``).  Call *before*
    :func:`configure`/:class:`inject` — the epoch is anchored there."""
    global _CLOCK
    with _LOCK:
        _CLOCK = clock if clock is not None else time.monotonic


def _fi_metrics():
    global _FM
    if _FM is None:
        _FM = _metrics.default_registry().counter(
            "faults_injected_total",
            "faults fired by the deterministic injector",
            labels=("point", "kind"))
    return _FM


def configure(spec: Optional[str] = None, seed: Optional[int] = None) -> None:
    """(Re)parse the fault spec — ``None`` reads ``DMLC_FAULT_INJECT`` /
    ``DMLC_FAULT_SEED``.  Resets per-rule counters and RNG streams."""
    global _RULES, _CONFIGURED_SPEC
    global _EPOCH
    spec = os.environ.get(_ENV_SPEC, "") if spec is None else spec
    if seed is None:
        try:
            seed = int(os.environ.get(_ENV_SEED, "") or _DEFAULT_SEED)
        except ValueError:
            seed = _DEFAULT_SEED
    with _LOCK:
        _RULES = _parse(spec, seed) if spec else []
        _CONFIGURED_SPEC = spec
        _EPOCH = _CLOCK()       # anchor the at=/every= schedule epoch


def _ensure_current() -> None:
    """Track env changes (monkeypatched tests, subprocess inheritance)
    unless an :class:`inject` context has pinned an explicit spec."""
    if _PINNED:
        return
    env_spec = os.environ.get(_ENV_SPEC, "")
    if env_spec != _CONFIGURED_SPEC:
        configure(env_spec)


def active() -> bool:
    """Is any fault rule live right now?"""
    _ensure_current()
    return bool(_RULES)


def check(point: str, ctx: str = "") -> Optional[Fault]:
    """The injection-point call: returns a :class:`Fault` when a rule
    for ``point`` fires (counted), else ``None``.  ``ctx`` is a free
    hint (URL, iter name) used only for logging by the site."""
    _ensure_current()
    if not _RULES:
        return None
    with _LOCK:
        elapsed = None          # schedule clock read at most once/check
        for rule in _RULES:
            if rule.point != point:
                continue
            rule.checked += 1
            if rule.checked <= rule.after:
                continue
            if rule.n is not None and rule.fires >= rule.n:
                continue
            if rule.at is not None or rule.every is not None:
                if elapsed is None:
                    elapsed = _CLOCK() - _EPOCH
                if rule.at is not None and elapsed < rule.at:
                    continue
                if rule.every is not None:
                    wave = int((elapsed - (rule.at or 0.0)) // rule.every)
                    if wave <= rule.last_wave:
                        continue
                    # one probability draw per wave, hit or miss — the
                    # fired-wave set is then a pure function of the seed
                    rule.last_wave = wave
            if rule.p < 1.0 and rule.rng.random() >= rule.p:
                continue
            rule.fires += 1
            fault = Fault(point, rule.kind, rule.value)
            break
        else:
            return None
    if _metrics.enabled():
        _fi_metrics().inc(1, point=point, kind=fault.kind)
    return fault


def fired_total() -> int:
    """Total faults fired by the CURRENT rule set (process-local rule
    counters; the cross-run evidence is the metrics counter)."""
    with _LOCK:
        return sum(r.fires for r in _RULES)


class inject:
    """Context manager for tests: pin a spec (and seed) for the block,
    restoring the previous configuration — env-driven or an enclosing
    ``inject`` — on exit.

    ::

        with faultinject.inject("http:error=503:p=1:n=2"):
            ...  # exactly the first two http checks fire
    """

    def __init__(self, spec: str, seed: int = _DEFAULT_SEED):
        self._spec = spec
        self._seed = seed
        self._saved: Optional[List[_Rule]] = None
        self._saved_spec: Optional[str] = None
        self._saved_epoch = 0.0

    def __enter__(self) -> "inject":
        global _PINNED
        with _LOCK:
            self._saved = _RULES
            self._saved_spec = _CONFIGURED_SPEC
            self._saved_epoch = _EPOCH
        configure(self._spec, self._seed)
        with _LOCK:
            _PINNED += 1
        return self

    def __exit__(self, *exc: Any) -> None:
        global _PINNED, _RULES, _CONFIGURED_SPEC, _EPOCH
        with _LOCK:
            _PINNED -= 1
            _RULES = self._saved or []
            _CONFIGURED_SPEC = self._saved_spec
            _EPOCH = self._saved_epoch


def stats() -> Dict[str, int]:
    """Per-rule fire counts keyed ``point:kind`` (diagnostics)."""
    with _LOCK:
        out: Dict[str, int] = {}
        for r in _RULES:
            key = f"{r.point}:{r.kind}"
            out[key] = out.get(key, 0) + r.fires
        return out


def rules() -> List[Dict[str, Any]]:
    """Full per-rule view — parsed grammar fields plus live counters —
    in spec order.  The chaos drills assert the schedule round-trips
    (grammar in == rules out) and that every scheduled rule fired."""
    with _LOCK:
        return [{"point": r.point, "kind": r.kind, "value": r.value,
                 "p": r.p, "n": r.n, "after": r.after, "at": r.at,
                 "every": r.every, "checked": r.checked,
                 "fires": r.fires, "last_wave": r.last_wave}
                for r in _RULES]
