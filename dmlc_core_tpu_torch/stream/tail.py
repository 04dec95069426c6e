"""Tail an append-only, growing RecordIO shard set.

The live-ingest end of the train→serve loop (doc/streaming.md): a
:class:`RecordIOTailer` follows a file, directory, glob pattern or
``';'`` list of RecordIO shards that one or more writers keep appending
to (and may extend with new shard files), delivering each record exactly
once per process in (file, offset) order.

Three failure realities of tailing live files, and their handling:

* **torn tail** — a writer mid-append leaves a partial header or payload
  at EOF.  The scanner only consumes *complete* records; torn bytes stay
  unconsumed and are re-examined on the next poll once the append lands
  (:mod:`~dmlc_core_tpu_torch.io.recordio`'s reader got the same tolerance for
  the non-tailing case).
* **corruption** — a byte range that is not a valid record part.  The
  scanner resyncs by searching 4-byte-aligned offsets for the RecordIO
  magic with a record-*start* cflag (the escaped-payload guarantee makes
  aligned magic an unambiguous boundary), skips the garbage, and counts
  it on ``dmlc_stream_resyncs_total``.
* **crash** — the consumer dies mid-refresh.  :meth:`commit` persists
  the ``{file: offset}`` cursor through ``parallel.checkpoint``'s
  atomic-write path (temp + rename, CRC sidecar, previous-version
  retention), so a SIGKILL during the commit itself leaves the prior
  cursor intact and a restart re-delivers only the uncommitted suffix —
  at-least-once delivery with an atomically-advancing floor.

Idle polling backs off through
:class:`~dmlc_core_tpu_torch.base.resilience.RetryPolicy` (exponential + full
jitter from ``DMLC_STREAM_POLL_S`` up to ``DMLC_STREAM_MAX_BACKOFF_S``),
resetting to the base interval the moment data arrives.

The PyTorch port's counterpart of ``dmlc_core_tpu/stream/tail.py``:
host code over the port's ``io`` layer.  The cursor leaf is written
through the port's ``parallel/checkpoint.py``, whose files are the JAX
package's, so a cursor written by either package resumes in the other.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dmlc_core_tpu_torch.base import knobs as _knobs
from dmlc_core_tpu_torch.base import metrics as _metrics
from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.base.resilience import RetryPolicy
from dmlc_core_tpu_torch.io.filesystem import FileInfo, FileSystem, URI
from dmlc_core_tpu_torch.io.recordio import (RECORDIO_MAGIC_BYTES, decode_chunk,
                                       decode_flag, decode_length)
from dmlc_core_tpu_torch.io.stream import SeekStream

__all__ = ["RecordIOTailer", "TailCursor"]

#: the ``like`` structure of a persisted cursor: one JSON-bytes leaf
_CURSOR_LIKE = {"cursor": np.zeros(0, np.uint8)}

_SM = None


def _stream_metrics():
    global _SM
    if _SM is None:
        r = _metrics.default_registry()
        _SM = {
            "records": r.counter(
                "stream_records_total",
                "records delivered by RecordIO tailers", labels=("tail",)),
            "resyncs": r.counter(
                "stream_resyncs_total",
                "magic-marker resyncs past corrupt/unparseable tail bytes",
                labels=("tail",)),
            "commits": r.counter(
                "stream_cursor_commits_total",
                "tail cursor checkpoints persisted", labels=("tail",)),
        }
    return _SM


class TailCursor:
    """The durable position of a tailer: consumed byte offset per file
    plus the running record count.  Serialized as JSON inside one
    checkpoint leaf (``parallel.checkpoint`` handles atomicity/CRC)."""

    def __init__(self, offsets: Optional[Dict[str, int]] = None,
                 records: int = 0):
        self.offsets: Dict[str, int] = dict(offsets or {})
        self.records = records

    def to_leaf(self) -> np.ndarray:
        blob = json.dumps({"files": self.offsets,
                           "records": self.records}).encode()
        return np.frombuffer(blob, np.uint8)

    @classmethod
    def from_leaf(cls, leaf: np.ndarray) -> "TailCursor":
        d = json.loads(np.asarray(leaf, np.uint8).tobytes().decode())
        return cls(offsets={str(k): int(v)
                            for k, v in d.get("files", {}).items()},
                   records=int(d.get("records", 0)))


def _pad4(n: int) -> int:
    return ((n + 3) >> 2) << 2


class RecordIOTailer:
    """Follow a growing RecordIO shard set, delivering complete records.

    ``uri`` may name a single file, a directory (its files sorted by
    path — shard writers must name new shards lexicographically after
    old ones), a glob pattern, or a ``';'``-separated list.  The set is
    re-listed on every poll, so shards that appear later are picked up.

    Single-consumer by design: all methods must be called from one
    thread (the online trainer's loop).  Delivery is at-least-once
    across process restarts — records delivered after the last
    :meth:`commit` are re-delivered on resume — and exactly-once within
    a process lifetime.
    """

    def __init__(self, uri: str, cursor_uri: Optional[str] = None,
                 poll_s: Optional[float] = None,
                 max_backoff_s: Optional[float] = None,
                 name: str = "tail"):
        self.name = name
        self._paths = [p for p in uri.split(";") if p]
        CHECK(len(self._paths) > 0, f"RecordIOTailer: empty uri {uri!r}")
        self._fs = FileSystem.get_instance(URI(self._paths[0]))
        CHECK(self._fs is not None,
              f"RecordIOTailer: no filesystem for {uri!r}")
        if poll_s is None:
            poll_s = float(_knobs.value("DMLC_STREAM_POLL_S"))
        if max_backoff_s is None:
            max_backoff_s = float(_knobs.value("DMLC_STREAM_MAX_BACKOFF_S"))
        CHECK(poll_s > 0, "RecordIOTailer: poll_s must be positive")
        #: jittered idle backoff: attempt k sleeps ≤ poll_s·2^(k-1),
        #: capped — the RetryPolicy backoff curve without its retry loop
        self._backoff = RetryPolicy(max_attempts=1 << 30,
                                    deadline_s=float("inf"),
                                    base_backoff_s=poll_s,
                                    max_backoff_s=max_backoff_s)
        self._cursor_uri = (cursor_uri if cursor_uri is not None
                            else str(_knobs.value("DMLC_STREAM_CURSOR")))
        self._streams: Dict[str, SeekStream] = {}
        self._commits = 0
        self.resyncs = 0
        cur = TailCursor()
        if self._cursor_uri:
            from dmlc_core_tpu_torch.parallel.checkpoint import load_checkpoint

            version, state = load_checkpoint(self._cursor_uri, _CURSOR_LIKE)
            if version > 0:
                cur = TailCursor.from_leaf(state["cursor"])
                LOG("INFO", "stream.tail %s: resuming from cursor v%d "
                    "(%d records, %d files)", name, version, cur.records,
                    len(cur.offsets))
                self._commits = version
        #: consumed byte offset per file path (advances only over
        #: complete records and skipped garbage)
        self._offsets: Dict[str, int] = cur.offsets
        #: records delivered since the cursor epoch began (persisted)
        self.records_seen = cur.records

    # -- discovery -------------------------------------------------------
    def _list_files(self) -> List[FileInfo]:
        out: List[FileInfo] = []
        for path in self._paths:
            try:
                out += self._fs.list_directory_ex(URI(path))
            except (OSError, IOError, FileNotFoundError):
                continue  # shard dir not created yet — normal at startup
        return sorted((f for f in out if f.size > 0), key=lambda f: f.path)

    # -- scanning --------------------------------------------------------
    def _find_record_start(self, buf: bytes, pos: int,
                           base_off: int) -> Optional[int]:
        """Next 4-byte-aligned (in file coordinates) offset ≥ ``pos``
        holding the magic with a record-start cflag and a fully readable
        header.  None when no verifiable candidate exists in ``buf``."""
        n = len(buf)
        p = buf.find(RECORDIO_MAGIC_BYTES, pos)
        while p >= 0:
            if (base_off + p) % 4 == 0 and p + 8 <= n:
                lrec = int.from_bytes(buf[p + 4:p + 8], "little")
                if decode_flag(lrec) in (0, 1):
                    return p
            p = buf.find(RECORDIO_MAGIC_BYTES, p + 1)
        return None

    def _scan(self, buf: bytes, base_off: int,
              max_records: Optional[int] = None) -> Tuple[int, List[bytes],
                                                          int]:
        """Extract complete records from ``buf`` (whose first byte sits
        at file offset ``base_off``), at most ``max_records`` of them.

        Returns ``(consumed, records, skipped)``: ``consumed`` bytes may
        be advanced past (complete records + resync'd garbage); a torn
        trailing record — and everything beyond ``max_records`` — is
        left unconsumed, so the cursor never runs ahead of what was
        actually delivered."""
        n = len(buf)
        pos = 0
        consumed = 0
        skipped = 0
        cur_start: Optional[int] = None
        spans: List[Tuple[int, int]] = []   # complete-record byte ranges
        while pos + 8 <= n:
            if max_records is not None and len(spans) >= max_records:
                break
            if buf[pos:pos + 4] != RECORDIO_MAGIC_BYTES:
                # corruption at what should be a record boundary: resync
                cur_start = None
                q = self._find_record_start(buf, pos + 1, base_off)
                if q is None:
                    # garbage to (near) the end; keep a 7-byte tail so a
                    # header straddling the next append is still found
                    tail_keep = min(n - pos, 7)
                    skipped += n - tail_keep - pos
                    consumed = max(consumed, n - tail_keep)
                    pos = n
                    break
                skipped += q - pos
                consumed = max(consumed, q)
                pos = q
                continue
            lrec = int.from_bytes(buf[pos + 4:pos + 8], "little")
            clen, cflag = decode_length(lrec), decode_flag(lrec)
            part_end = pos + 8 + _pad4(clen)
            if part_end > n:
                break                       # torn tail — wait for append
            if cflag in (0, 1):
                cur_start = pos
            if cflag in (2, 3) and cur_start is None:
                # continuation without a start (resync landed mid-record)
                skipped += part_end - pos
                consumed = max(consumed, part_end)
            elif cflag in (0, 3):
                spans.append((cur_start, part_end))  # type: ignore[arg-type]
                consumed = max(consumed, part_end)
                cur_start = None
            pos = part_end
        if skipped:
            self.resyncs += 1
            LOG("WARNING", "stream.tail %s: resync skipped %d corrupt "
                "bytes near offset %d", self.name, skipped,
                base_off + consumed)
            if _metrics.enabled():
                _stream_metrics()["resyncs"].inc(1, tail=self.name)
        records: List[bytes] = []
        # merge contiguous spans so decode_chunk runs once per clean run
        i = 0
        while i < len(spans):
            s, e = spans[i]
            while i + 1 < len(spans) and spans[i + 1][0] == e:
                e = spans[i + 1][1]
                i += 1
            records.extend(decode_chunk(buf[s:e]))
            i += 1
        return consumed, records, skipped

    # -- reading ---------------------------------------------------------
    def _open(self, path: str) -> SeekStream:
        s = self._streams.get(path)
        if s is None:
            s = self._fs.open_for_read(URI(path))
            self._streams[path] = s
        return s

    def poll(self, max_records: Optional[int] = None) -> List[bytes]:
        """Deliver complete unseen records available right now
        (non-blocking beyond the storage reads), at most
        ``max_records``.  Undelivered surplus stays unconsumed — the
        cursor floor only ever covers delivered records."""
        out: List[bytes] = []
        for info in self._list_files():
            if max_records is not None and len(out) >= max_records:
                break
            path = info.path
            off = self._offsets.get(path, 0)
            if info.size < off:
                # shrunk file = truncated/rewritten shard; restart it
                LOG("WARNING", "stream.tail %s: %s shrank (%d < %d) — "
                    "re-reading from 0", self.name, path, info.size, off)
                self._streams.pop(path, None)
                off = 0
            if info.size <= off:
                continue
            try:
                stream = self._open(path)
                stream.seek(off)
                buf = stream.read(info.size - off)
            except (OSError, IOError):
                self._streams.pop(path, None)
                continue                   # transient — retry next poll
            consumed, records, _skipped = self._scan(
                buf, off, None if max_records is None
                else max_records - len(out))
            if consumed:
                self._offsets[path] = off + consumed
            out.extend(records)
        if out:
            self.records_seen += len(out)
            if _metrics.enabled():
                _stream_metrics()["records"].inc(len(out), tail=self.name)
        return out

    def wait_records(self, n: int = 1, timeout: Optional[float] = None,
                     stop: Optional[Callable[[], bool]] = None
                     ) -> List[bytes]:
        """Poll (with jittered exponential idle backoff) until exactly
        ``n`` records are gathered, ``timeout`` seconds pass, or
        ``stop()`` goes true.  Never returns more than ``n`` (surplus
        stays unconsumed for the next call); may return fewer on
        timeout/stop, possibly none."""
        out: List[bytes] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        idle = 0
        while len(out) < n:
            if stop is not None and stop():
                break
            got = self.poll(max_records=n - len(out))
            if got:
                out.extend(got)
                idle = 0
                continue
            if deadline is not None and time.monotonic() >= deadline:
                break
            idle += 1
            delay = self._backoff.backoff_for(idle)
            if deadline is not None:
                delay = min(delay, max(deadline - time.monotonic(), 0.0))
            if delay > 0:
                time.sleep(delay)
        return out

    # -- durability ------------------------------------------------------
    def cursor(self) -> TailCursor:
        """The current (in-memory) position."""
        return TailCursor(self._offsets, self.records_seen)

    def commit(self) -> int:
        """Atomically persist the cursor (monotone version); returns the
        committed version.  Requires a ``cursor_uri``.  A crash during
        the commit leaves the previous cursor intact (checkpoint's
        temp-file + rename semantics), so resume never skips records."""
        CHECK(self._cursor_uri != "",
              "RecordIOTailer.commit: no cursor_uri configured")
        from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint

        self._commits += 1
        checkpoint(self._cursor_uri, {"cursor": self.cursor().to_leaf()},
                   version=self._commits)
        if _metrics.enabled():
            _stream_metrics()["commits"].inc(1, tail=self.name)
        return self._commits

    def close(self) -> None:
        for s in self._streams.values():
            try:
                s.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._streams.clear()

    def __enter__(self) -> "RecordIOTailer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
