"""Checkpoint / resume of state trees over any Stream URI (PyTorch port).

Reference parity: dmlc-core provides checkpoint *mechanism*, not policy —
``Stream``/``Serializable`` binary round-trip to any URI, which rabit's
``CheckPoint()/LoadCheckPoint()`` and XGBoost model I/O build on
(SURVEY.md §5).  Here the same layering carries state trees:

* ``checkpoint(uri, tree)`` — host-gathers each leaf and serializes
  through the Stream layer, so checkpoints inherit every filesystem
  backend (local, ``mem://``) for free.
* rabit parity: ``version_number`` round-trips with the state, and
  ``load_checkpoint`` returns ``(version, state)`` with version 0 when no
  checkpoint exists — exactly the resume-loop contract XGBoost uses.

Durability (doc/robustness.md):

* **Atomic commit** — local files are written to ``<uri>.tmp`` and
  ``os.replace``d into place, so a SIGKILL mid-checkpoint can never
  destroy the previous version; object-store backends already commit
  on close (``BufferedWriteStream``), and ``mem://`` now does too.
* **Per-leaf CRC32** — a JSON *sidecar* (``<uri>.crc``) records one
  CRC per serialized leaf.  The checkpoint file's own bytes are
  unchanged from the pre-sidecar format, so old checkpoints still load
  (no sidecar → no validation) and new files stay bit-compatible.
* **Prior-version retention + fallback** — before overwriting, the
  previous checkpoint is kept as ``<uri>.prev`` (local/mem by default;
  ``DMLC_CKPT_KEEP=0`` disables, ``=1`` forces it on for remote URIs
  at the cost of a copy).  ``load_checkpoint`` falls back to the
  newest valid prior version when the primary is corrupt — detected by
  magic, framing, CRC, or leaf-count failure — and counts the event on
  ``dmlc_checkpoint_fallbacks_total``.

The ``checkpoint`` fault-injection point (``base.faultinject``) sits
between payload write and commit: ``kill`` SIGKILLs the process there
(the crash-mid-write drill ``scripts/check_resilience.py`` runs),
``abort`` raises instead, and ``corrupt`` flips a byte post-commit to
exercise CRC detection and fallback.

The PyTorch port's counterpart of ``dmlc_core_tpu/parallel/checkpoint.py``,
its unsharded path: the same file bytes (magic, version, leaf list), CRC
sidecar, ``.prev`` retention and fault points, over the port's
``io/stream.py`` and ``io/serializer.py``, so a checkpoint written by
either package loads in the other.  Where JAX flattens a pytree
(``jax.tree``), this module flattens dicts (keys sorted), lists and
tuples of numpy arrays, torch tensors and scalars in the same leaf order
(``None`` has no leaf), and loads tensor leaves onto the device of the
``like`` leaf.

``sharded=True`` writes and reads one file per rank,
``uri.shard-K-of-N`` in the JAX file format, each holding this rank's
leaves as they are (one process per GPU: every tensor of a rank is its
own, so no leaf is split across ranks; JAX's per-shard leaf lists, which
a multi-device process writes for arrays it addresses only in part, have
no counterpart and raise at load).  In a world
of one it is the unsharded path, as in JAX.  ``local=True`` (this caller
writes ``uri`` itself, no rank-0 election and no barrier) is the per-rank
commit of the elastic recovery layer and of the parameter server's
snapshots.
"""

from __future__ import annotations

import json
import os
import signal
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np

import torch

from dmlc_core_tpu_torch.base import faultinject as _fi
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG, Error
from dmlc_core_tpu_torch.io import serializer as ser
from dmlc_core_tpu_torch.io.filesystem import URI
from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.parallel import collectives as coll

__all__ = ["checkpoint", "load_checkpoint"]

_MAGIC = 0xC4EC7A90
_CRC_SUFFIX = ".crc"
_PREV_SUFFIX = ".prev"

_CM = None


def _ckpt_metrics():
    global _CM
    if _CM is None:
        r = _metrics.default_registry()
        _CM = {
            "corrupt": r.counter(
                "checkpoint_corrupt_total",
                "checkpoint candidates rejected as corrupt at load"),
            "fallbacks": r.counter(
                "checkpoint_fallbacks_total",
                "loads served from a prior retained version"),
        }
    return _CM


def _flatten(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order: dict
    values by sorted key, list and tuple items in order, no leaf for
    ``None``, anything else one leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` in :func:`_flatten`'s order
    (consumed from the front of the list)."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        if isinstance(like, list):
            return items
        return (type(like)(*items) if hasattr(like, "_fields")
                else type(like)(items))
    return leaves.pop(0)


def _to_host(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return leaf


def _local_path(uri: str) -> Optional[str]:
    """Filesystem path for local URIs (where rename-atomicity exists)."""
    parsed = URI(uri)
    if parsed.protocol in ("", "file://"):
        return parsed.name
    return None


def _keep_prev(uri: str) -> bool:
    """Retain the previous version?  Default: yes where the copy is free
    (local rename, in-memory), no for remote object stores (it would
    cost a download per save) — ``DMLC_CKPT_KEEP`` overrides both."""
    raw = os.environ.get("DMLC_CKPT_KEEP", "")
    if raw != "":
        return raw.lower() not in ("0", "false", "off", "no")
    return _local_path(uri) is not None or uri.startswith("mem://")


class _CrcStream(Stream):
    """Pass-through Stream accumulating CRC32 of the bytes moved —
    resettable, so one wrapper yields per-leaf checksums."""

    def __init__(self, inner: Stream):
        self._inner = inner
        self.crc = 0

    def reset(self) -> None:
        self.crc = 0

    def read(self, nbytes: int) -> bytes:
        data = self._inner.read(nbytes)
        self.crc = zlib.crc32(data, self.crc)
        return data

    def write(self, data: bytes) -> int:
        self.crc = zlib.crc32(bytes(data), self.crc)
        return self._inner.write(data)


def _write_body(stream: Stream, version: int, leaves: List[Any]) -> List[int]:
    """Serialize header + leaf list (byte-identical to the historical
    ``write_obj(list)`` framing) and return one CRC32 per leaf."""
    ser.write_uint32(stream, _MAGIC)
    ser.write_uint64(stream, version)
    stream.write(bytes([ser._TAG_LIST]))
    ser.write_uint64(stream, len(leaves))
    crc = _CrcStream(stream)
    crcs = []
    for leaf in leaves:
        crc.reset()
        ser.write_obj(crc, leaf)
        crcs.append(crc.crc)
    return crcs


def _read_body(stream: Stream,
               crcs: Optional[List[int]]) -> Tuple[int, List[Any]]:
    """Inverse of :func:`_write_body`; validates per-leaf CRCs when a
    sidecar supplied them."""
    magic = ser.read_uint32(stream)
    CHECK(magic == _MAGIC, "checkpoint: bad magic")
    version = ser.read_uint64(stream)
    tag = stream.read_exact(1)[0]
    CHECK(tag == ser._TAG_LIST, "checkpoint: bad payload framing")
    n = ser.read_uint64(stream)
    if crcs is not None:
        CHECK(len(crcs) == n,
              f"checkpoint: sidecar lists {len(crcs)} leaves, file has {n}")
    crc = _CrcStream(stream)
    leaves = []
    for i in range(n):
        crc.reset()
        leaves.append(ser.read_obj(crc))
        if crcs is not None:
            CHECK(crc.crc == crcs[i],
                  f"checkpoint: CRC mismatch on leaf {i}")
    return int(version), leaves


def _write_blob(uri: str, write_fn) -> None:
    """Write through ``write_fn(stream)`` atomically: local URIs go via
    ``<path>.tmp`` + ``os.replace``; other backends commit on close."""
    path = _local_path(uri)
    if path is None:
        stream = Stream.create(uri, "w")
        write_fn(stream)
        stream.close()
        return
    tmp = path + f".tmp.{os.getpid()}"
    try:
        stream = Stream.create(tmp, "w")
        write_fn(stream)
        stream.close()
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _copy_blob(src: str, dst: str) -> bool:
    """Retain ``src`` as ``dst`` (rename locally, byte copy elsewhere).
    Returns False when ``src`` does not exist."""
    spath, dpath = _local_path(src), _local_path(dst)
    if spath is not None and dpath is not None:
        if not os.path.exists(spath):
            return False
        os.replace(spath, dpath)
        return True
    s = Stream.create(src, "r", allow_null=True)
    if s is None:
        return False
    data = s.read_all()
    s.close()
    _write_blob(dst, lambda out: out.write(data))
    return True


def _remove_local(uri: str) -> None:
    """Remove a local file if it exists (other backends: nothing; their
    retention copies, so the primary keeps its own sidecar)."""
    path = _local_path(uri)
    if path is not None:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


def _read_sidecar(uri: str) -> Optional[List[int]]:
    """Leaf CRCs from ``<uri>.crc`` — ``None`` when absent (pre-sidecar
    checkpoint: skip validation); raises on a garbled sidecar (treated
    as corruption by the caller)."""
    s = Stream.create(uri + _CRC_SUFFIX, "r", allow_null=True)
    if s is None:
        return None
    try:
        doc = json.loads(s.read_all())
    finally:
        s.close()
    crcs = doc["leaf_crcs"]
    CHECK(isinstance(crcs, list), "checkpoint: bad sidecar")
    return [int(c) for c in crcs]


def _corrupt_blob(uri: str) -> None:
    """``checkpoint:corrupt`` fault: flip one mid-file byte post-commit."""
    path = _local_path(uri)
    if path is not None:
        with open(path, "r+b") as f:
            size = os.path.getsize(path)
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        return
    s = Stream.create(uri, "r", allow_null=True)
    if s is None:
        return
    data = bytearray(s.read_all())
    s.close()
    data[len(data) // 2] ^= 0xFF
    with Stream.create(uri, "w") as out:
        out.write(bytes(data))


def checkpoint(uri: str, state: Any, version: int = 0, sharded: bool = False,
               local: bool = False) -> None:
    """Save a tree of arrays/tensors/scalars.  Reference: rabit
    ``CheckPoint``.

    ``sharded=True`` writes one file per process (``uri.shard-K-of-N``)
    holding this rank's own leaves — no barrier, no rank-0 election.

    ``local=True`` skips the collective semantics entirely: THIS caller
    writes ``uri`` as given (per-rank recovery commits, where a dying
    peer must not wedge the commit path).

    The write is crash-safe: payload lands in a temp file (or a commit-
    on-close backend stream) and only a complete write replaces ``uri``;
    with retention on (see ``DMLC_CKPT_KEEP``) the replaced version
    survives as ``uri + ".prev"`` for corruption fallback.
    """
    world = coll.world_size()
    if sharded and not local and world > 1:
        uri = _shard_uri(uri)
    elif not local and world > 1 and coll.rank() != 0:
        # symmetric by construction: non-root ranks barrier here and
        # return, rank 0 barriers at the end of the write path below
        # — every rank reaches exactly one "ckpt" barrier
        coll.barrier("ckpt")  # dmlcheck: off:collective-discipline
        return  # replicated state: rank 0 writes
    payload = [_to_host(x) for x in _flatten(state)]

    if _keep_prev(uri):
        # the current version becomes the fallback BEFORE anything is
        # replaced; its sidecar travels with it, and FIRST (ROADMAP C19):
        # a kill between the two moves leaves the primary's complete body
        # without a sidecar (loaded unvalidated), where moving the body
        # first left no primary and a fallback body beside the older
        # version's sidecar — no loadable version at all
        if not _copy_blob(uri + _CRC_SUFFIX,
                          uri + _PREV_SUFFIX + _CRC_SUFFIX):
            _remove_local(uri + _PREV_SUFFIX + _CRC_SUFFIX)
        _copy_blob(uri, uri + _PREV_SUFFIX)
    else:
        # nothing retained: a stale sidecar must not outlive its body
        _remove_local(uri + _CRC_SUFFIX)

    crcs: List[int] = []

    def _write(stream: Stream) -> None:
        crcs.extend(_write_body(stream, version, payload))
        fault = _fi.check("checkpoint", ctx=uri)
        if fault is not None:
            if fault.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            if fault.kind in ("abort", "error"):
                raise IOError(f"fault injected: checkpoint abort ({uri})")

    _write_blob(uri, _write)
    _write_blob(uri + _CRC_SUFFIX, lambda s: s.write(json.dumps(
        {"version": version, "algo": "crc32", "leaf_crcs": crcs}).encode()))

    fault = _fi.check("checkpoint-post", ctx=uri)
    if fault is not None and fault.kind == "corrupt":
        _corrupt_blob(uri)

    if world > 1 and not sharded and not local:
        coll.barrier("ckpt")


def _shard_uri(uri: str) -> str:
    """This rank's shard file of ``uri``: ``uri.shard-K-of-N``."""
    return f"{uri}.shard-{coll.rank()}-of-{coll.world_size()}"


def _rebuild(payload: List[Any], like: Any) -> Any:
    """Reassemble a leaf payload into the structure of ``like``; a
    tensor leaf of ``like`` gives the device its saved array goes to."""
    leaves = _flatten(like)
    CHECK(len(payload) == len(leaves), "checkpoint: leaf count mismatch")
    out_leaves = []
    for saved, ref in zip(payload, leaves):
        CHECK(not (isinstance(saved, list) and saved
                   and isinstance(saved[0], tuple)),
              "checkpoint: a leaf saved as a JAX process's addressable "
              "shards (a multi-device process); the port holds one "
              "device per process and loads whole leaves only")
        if isinstance(ref, torch.Tensor):
            out_leaves.append(torch.from_numpy(
                np.array(saved)).to(ref.device))
        else:
            out_leaves.append(saved)
    return _unflatten(like, out_leaves)


def load_checkpoint(uri: str, like: Any, sharded: bool = False) -> Tuple[int, Any]:
    """Load a checkpoint into the structure of ``like``.

    Returns ``(version, state)``; ``(0, like)`` when no checkpoint exists —
    rabit's ``LoadCheckPoint`` contract for cold starts.

    Corruption recovery: a primary that fails magic/framing/CRC/leaf
    validation is rejected (``dmlc_checkpoint_corrupt_total``) and the
    newest valid prior version (``uri + ".prev"``) is served instead
    (``dmlc_checkpoint_fallbacks_total``); only when every candidate is
    corrupt does the load raise.
    """
    if sharded and coll.world_size() > 1:
        uri = _shard_uri(uri)
    first_error: Optional[BaseException] = None
    any_present = False
    for idx, cand in enumerate((uri, uri + _PREV_SUFFIX)):
        stream = Stream.create(cand, "r", allow_null=True)
        if stream is None:
            continue
        any_present = True
        try:
            try:
                crcs = _read_sidecar(cand)
                version, payload = _read_body(stream, crcs)
            finally:
                stream.close()
            state = _rebuild(payload, like)
        except Exception as e:  # noqa: BLE001 — any parse failure = corrupt
            if _metrics.enabled():
                _ckpt_metrics()["corrupt"].inc(1)
            LOG("WARNING", "checkpoint %s: corrupt (%s: %s)%s", cand,
                type(e).__name__, e,
                "; trying prior version" if idx == 0 else "")
            if first_error is None:
                first_error = e
            continue
        if idx > 0:
            if _metrics.enabled():
                _ckpt_metrics()["fallbacks"].inc(1)
            LOG("WARNING", "checkpoint %s: recovered from prior version "
                "%s (v%d)", uri, cand, version)
        return version, state
    if not any_present:
        return 0, like
    raise Error(f"checkpoint {uri}: no valid version "
                f"(last error: {first_error})")
