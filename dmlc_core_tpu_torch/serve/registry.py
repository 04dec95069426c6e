"""Versioned model registry with atomic hot-swap.

Checkpoint layering (rabit parity end-to-end): a served model travels as
a ``parallel.checkpoint`` pytree whose single leaf is the model's own
``save_model`` byte payload — so serving checkpoints inherit every
Stream URI backend (``file://``, ``mem://``, object stores) AND the
versioned ``(version, state)`` resume contract ``load_checkpoint``
already guarantees (version 0 ≡ absent).  The payload is self-describing
via each model family's magic prefix, so :func:`load_model_checkpoint`
reconstructs the right class without a side-channel.

Hot-swap: :meth:`ModelRegistry.publish` wraps the model in a
:class:`~dmlc_core_tpu_torch.serve.runner.ModelRunner` and rebinds the
``(version, runner)`` current-pointer in one atomic reference swap.  A
batch in flight resolved the OLD tuple before the swap and finishes on
it (the runner stays alive as long as the batch holds the reference);
every batch assembled after the swap sees the new version — zero dropped
requests, no lock held across model execution.

Version discipline: publishes must be strictly monotonic (a stale
version number is a deployment bug and raises); :meth:`activate` may
point ``current`` back at any retained version (rollback) without
disturbing the monotonic publish history.

The PyTorch port's counterpart of ``dmlc_core_tpu/serve/registry.py``.
The magic loaders name the port's four families (``HistGBT``,
``SparseHistGBT``, ``GBLinear``, ``FM``), whose files are the JAX
package's, so a serving checkpoint written by either package loads in
the other.  Loaders take ``device=`` (``None``: ``cuda``, as every entry
point of the port); :class:`ModelRegistry` passes its own ``device`` to
:meth:`ModelRegistry.load`.  The class carries the JAX class's
race-checker instrumentation and exemption (``base/racecheck.py``).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.racecheck import instrument_class
from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint, load_checkpoint
from dmlc_core_tpu_torch.serve.instruments import serve_metrics
from dmlc_core_tpu_torch.serve.runner import ModelRunner

__all__ = ["ModelRegistry", "checkpoint_model", "load_model_checkpoint",
           "clone_model", "model_to_bytes", "model_from_bytes"]

#: scratch-key counter for mem:// round-trips of model payloads
_SCRATCH = itertools.count()

#: the ``like`` structure of a model checkpoint: one opaque byte leaf
_LIKE = {"model": np.zeros(0, np.uint8)}


def _magic_loaders() -> List[Tuple[bytes, Callable[..., Any]]]:
    """(magic prefix, load_model) per family — resolved lazily so the
    registry import does not pull every model module.  Each loader takes
    ``(uri, device=)``."""
    from dmlc_core_tpu_torch.models.fm import FM
    from dmlc_core_tpu_torch.models.histgbt import HistGBT
    from dmlc_core_tpu_torch.models.histgbt_sparse import SparseHistGBT
    from dmlc_core_tpu_torch.models.linear import GBLinear

    return [
        (HistGBT._MODEL_MAGIC, HistGBT.load_model),
        (SparseHistGBT._MODEL_MAGIC, SparseHistGBT.load_model),
        (GBLinear._MODEL_MAGIC, GBLinear.load_model),
        (FM._MODEL_MAGIC, FM.load_model),
    ]


def _scratch_round_trip(write: Callable[[str], None]) -> bytes:
    """Run a save/load callable against a throwaway mem:// URI and
    return (then free) the bytes it produced."""
    from dmlc_core_tpu_torch.io.filesystem import MemoryFileSystem

    key = f"/_serve_scratch/{next(_SCRATCH)}"
    write(f"mem://{key}")
    try:
        with Stream.create(f"mem://{key}", "r") as s:
            return s.read_all()
    finally:
        MemoryFileSystem._files.pop(key, None)


def _model_to_bytes(model: Any) -> bytes:
    CHECK(hasattr(model, "save_model"),
          f"{type(model).__name__} has no save_model — cannot checkpoint")
    return _scratch_round_trip(model.save_model)


def _model_from_bytes(blob: bytes, device: Any = None) -> Any:
    from dmlc_core_tpu_torch.io.filesystem import MemoryFileSystem

    for magic, loader in _magic_loaders():
        if blob[:len(magic)] == magic:
            key = f"/_serve_scratch/{next(_SCRATCH)}"
            MemoryFileSystem._files[key] = bytearray(blob)
            try:
                return loader(f"mem://{key}", device=device)
            finally:
                MemoryFileSystem._files.pop(key, None)
    raise ValueError(
        f"model checkpoint has unknown magic prefix {blob[:16]!r}")


def model_to_bytes(model: Any) -> bytes:
    """Public form of the save_model byte round trip: the exact payload
    :func:`checkpoint_model` embeds.  The tenancy tier retains these
    blobs as its paging source of truth (an evicted model is rebuilt
    from its blob, so a page-in is bit-identical to the publish)."""
    return _model_to_bytes(model)


def model_from_bytes(blob: bytes, device: Any = None) -> Any:
    """Inverse of :func:`model_to_bytes` — the magic prefix picks the
    model family, no side-channel needed; the model lands on ``device``
    (``None``: ``cuda``)."""
    return _model_from_bytes(blob, device)


def clone_model(model: Any) -> Any:
    """Deep-copy a model via its own ``save_model`` byte round trip —
    the snapshot a publisher must take before handing a continuously
    retrained model to the registry (a shared reference would mutate
    under in-flight batches on the next refresh).  The copy lands on the
    model's own device."""
    return _model_from_bytes(_model_to_bytes(model),
                             getattr(model, "device", None))


def checkpoint_model(uri: str, model: Any, version: int) -> None:
    """Write ``model`` to ``uri`` as a versioned serving checkpoint
    (``version`` must be >= 1; 0 is the absent sentinel)."""
    CHECK(version >= 1, f"model versions start at 1, got {version}")
    blob = _model_to_bytes(model)
    checkpoint(uri, {"model": np.frombuffer(blob, np.uint8)},
               version=version)


def load_model_checkpoint(uri: str, device: Any = None
                          ) -> Tuple[int, Optional[Any]]:
    """Inverse of :func:`checkpoint_model`: ``(version, model)``, or
    ``(0, None)`` when no checkpoint exists — the ``load_checkpoint``
    cold-start contract carried through to models.  The model lands on
    ``device`` (``None``: ``cuda``)."""
    version, state = load_checkpoint(uri, _LIKE)
    if version == 0 and state is _LIKE:
        return 0, None
    return version, _model_from_bytes(np.asarray(state["model"]).tobytes(),
                                      device)


@instrument_class
class ModelRegistry:
    """Versioned runners with an atomically swappable current pointer.

    ``runner_opts`` (``max_batch``, ``min_bucket``) apply to every
    published model so all versions share one batch-bucket ladder — a
    hot-swap must not change which shapes the batcher produces.
    ``device`` is where :meth:`load` puts a checkpoint's model
    (``None``: ``cuda``); a published model stays where it is."""

    #: ``_current`` is read lock-free BY DESIGN (one atomic reference
    #: fetch of an immutable tuple — see current()); the same rationale
    #: as its ``# dmlcheck: off:lock-discipline`` suppressions, spelled
    #: in racecheck's vocabulary
    _racecheck_exempt = frozenset({"_current"})

    def __init__(self, name: str = "default", device: Any = None,
                 **runner_opts: Any):
        self.name = name
        self.device = device
        self._runner_opts = dict(runner_opts)
        self._lock = threading.Lock()
        self._versions: Dict[int, ModelRunner] = {}
        self._current: Optional[Tuple[int, ModelRunner]] = None

    # -- publication -----------------------------------------------------
    def publish(self, model: Any, version: Optional[int] = None,
                source: Optional[str] = None, activate: bool = True) -> int:
        """Register ``model`` (wrapped in a :class:`ModelRunner`) and
        atomically make it current.  ``version=None`` auto-increments;
        an explicit version must exceed every published version.

        ``activate=False`` **stages** the version instead: it is
        retained (and counts toward monotonicity) but the current
        pointer does not move — traffic keeps flowing to the old
        version until an explicit :meth:`activate`.  This is the
        publish-then-gate path the streaming publisher uses
        (doc/streaming.md)."""
        runner = ModelRunner(model, name=self.name, **self._runner_opts)
        with self._lock:
            last = max(self._versions) if self._versions else 0
            if version is None:
                version = last + 1
            CHECK(version > last,
                  f"registry {self.name!r}: version {version} is not "
                  f"monotonic (latest published is {last})")
            self._versions[version] = runner
            if activate:
                self._current = (version, runner)   # THE atomic swap
        LOG("INFO", "serve.registry %s: %s v%d (%s)%s",
            self.name, "published" if activate else "staged", version,
            type(model).__name__, f" from {source}" if source else "")
        if _metrics.enabled():
            serve_metrics()["model_info"].set(
                1, version=str(version),
                source=source or type(model).__name__)
        return version

    def load(self, uri: str, activate: bool = True) -> int:
        """Load a serving checkpoint from any Stream URI and publish it
        under the checkpoint's own version (hot-swap path).  A missing
        checkpoint is a loud error — serving has no cold-start state.

        ``activate=False`` stages the version instead of switching
        traffic to it — the fleet rollout's publish-everywhere-first
        step (doc/serving.md, Fleet section)."""
        version, model = load_model_checkpoint(uri, self.device)
        CHECK(model is not None, f"no model checkpoint at {uri}")
        return self.publish(model, version=version, source=uri,
                            activate=activate)

    def save(self, uri: str, version: Optional[int] = None) -> None:
        """Checkpoint a retained version (default: current) to ``uri``."""
        version, runner = (self.current() if version is None
                           else (version, self.get(version)))
        checkpoint_model(uri, runner.model, version)

    # -- resolution ------------------------------------------------------
    def current(self) -> Tuple[int, ModelRunner]:
        """The ``(version, runner)`` pair to execute a batch on.  Read
        once per batch: the tuple is immutable, so a concurrent publish
        cannot tear it and in-flight batches finish on what they saw."""
        # deliberate lock-free read: one atomic reference fetch of an
        # immutable tuple (see class docstring) — a lock here would
        # serialize every batch against publish
        cur = self._current  # dmlcheck: off:lock-discipline
        CHECK(cur is not None,
              f"registry {self.name!r}: no model published")
        return cur

    def current_version(self) -> Optional[int]:
        """Current version number, or None before the first publish."""
        cur = self._current  # dmlcheck: off:lock-discipline (same as current())
        return None if cur is None else cur[0]

    def get(self, version: int) -> ModelRunner:
        """Retained runner for ``version`` (KeyError when unknown)."""
        with self._lock:
            return self._versions[version]

    def versions(self) -> List[int]:
        """All retained versions, ascending."""
        with self._lock:
            return sorted(self._versions)

    def activate(self, version: int) -> None:
        """Point ``current`` at an already-retained version (rollback);
        publish history stays monotonic."""
        with self._lock:
            CHECK(version in self._versions,
                  f"registry {self.name!r}: unknown version {version}")
            self._current = (version, self._versions[version])
        LOG("INFO", "serve.registry %s: activated v%d", self.name, version)
