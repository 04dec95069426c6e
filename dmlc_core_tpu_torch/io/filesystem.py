"""Filesystem abstraction with protocol-dispatched backends.

Reference parity: ``src/io/filesys.{h,cc} :: FileSystem (Open/OpenForRead/
GetPathInfo/ListDirectory), FileInfo, URI`` plus ``src/io/local_filesys.cc ::
LocalFileSystem`` and ``include/dmlc/filesystem.h :: TemporaryDirectory``
(SURVEY.md §2b).

Backends self-register in the ``"filesystem"`` Registry keyed by protocol
(``""``/``"file://"`` local, ``"mem://"`` in-memory).  Remote object stores
(the reference's S3/HDFS/Azure; GCS is the idiomatic TPU-world equivalent)
plug in behind the same interface — the URI routing, sharding math and
checkpoint layers above never change.

This package's own copy of ``dmlc_core_tpu.io.filesystem``: local files and
the in-process ``mem://`` filesystem; the remote ones (``io/*_filesys.py``)
register their protocols here when ``io`` is imported.
"""

from __future__ import annotations

import fnmatch as _fnmatch
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal
from dmlc_core_tpu_torch.base.registry import Registry
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream

__all__ = [
    "URI",
    "FileInfo",
    "FileSystem",
    "LocalFileSystem",
    "MemoryFileSystem",
    "TemporaryDirectory",
]

FS_REGISTRY: Registry = Registry.get("filesystem")


class URI:
    """Parsed URI: protocol, host, name (path).

    Reference parity: ``src/io/filesys.h :: dmlc::io::URI`` — a bare path
    has protocol ``""``; ``file:///a/b`` → protocol ``file://``, name
    ``/a/b``; ``s3://bucket/key`` → protocol ``s3://``, host ``bucket``,
    name ``/key``.
    """

    def __init__(self, uri: str):
        self.raw = uri
        if "://" in uri:
            proto, rest = uri.split("://", 1)
            self.protocol = proto + "://"
            if self.protocol in ("file://", "mem://"):
                self.host = ""
                self.name = rest if rest.startswith("/") else "/" + rest
            else:
                host, _, path = rest.partition("/")
                self.host = host
                self.name = "/" + path
        else:
            self.protocol = ""
            self.host = ""
            self.name = uri

    def str_no_protocol(self) -> str:
        return (self.host + self.name) if self.host else self.name

    def __repr__(self) -> str:
        return f"URI({self.raw!r})"


@dataclass
class FileInfo:
    """Reference parity: ``dmlc::io::FileInfo{path, size, type}``."""

    path: str
    size: int = 0
    type: str = "file"  # "file" | "directory"


class FileSystem:
    """Abstract storage backend.

    Subclasses register a factory in ``FS_REGISTRY`` under their protocol
    string.  ``get_instance`` is the dispatch point used by
    ``Stream.create`` and ``InputSplit.create``.
    """

    @staticmethod
    def get_instance(uri: URI) -> Optional["FileSystem"]:
        """Reference parity: ``FileSystem::GetInstance(URI)``."""
        entry = FS_REGISTRY.find(uri.protocol)
        if entry is None:
            return None
        return entry()

    # -- backend interface ----------------------------------------------
    def open(self, uri: URI, mode: str) -> Stream:
        raise NotImplementedError

    def open_for_read(self, uri: URI) -> SeekStream:
        s = self.open(uri, "r")
        CHECK(isinstance(s, SeekStream), "backend must return SeekStream for reads")
        return s  # type: ignore[return-value]

    def get_path_info(self, uri: URI) -> FileInfo:
        raise NotImplementedError

    def list_directory(self, uri: URI) -> List[FileInfo]:
        raise NotImplementedError

    def list_directory_ex(self, uri: URI) -> List[FileInfo]:
        """List a path that may be a file, a directory, or a glob pattern.

        This is the entry point the input-split sharding math uses: it must
        return a deterministic (sorted) list of plain files.  Mirrors the
        reference's multi-path handling in ``input_split_base.cc`` where a
        URI may name a directory of part files.
        """
        name = uri.name
        if any(ch in name for ch in "*?["):
            # glob on the basename, matched against this backend's own
            # listing (never the OS filesystem — backends own their namespace)
            parent, _, pattern = name.rpartition("/")
            if not parent:
                # '/x*' → root; bare relative 'x*' → current directory
                parent = "/" if name.startswith("/") else "."
            parent_uri = URI(uri.protocol + uri.host + parent)
            out = [
                f
                for f in self.list_directory(parent_uri)
                if f.type == "file" and _fnmatch.fnmatch(f.path.rsplit("/", 1)[-1], pattern)
            ]
            return sorted(out, key=lambda f: f.path)
        info = self.get_path_info(uri)
        if info.type == "directory":
            return sorted(
                (f for f in self.list_directory(uri) if f.type == "file"),
                key=lambda f: f.path,
            )
        return [info]


class _LocalFileStream(SeekStream):
    """fopen64-equivalent local file stream (Python files are 64-bit clean)."""

    def __init__(self, path: str, mode: str):
        self._f = open(path, mode + "b")

    def read(self, nbytes: int) -> bytes:
        return self._f.read(nbytes if nbytes >= 0 else None)

    def write(self, data: bytes) -> int:
        return self._f.write(data)

    def seek(self, pos: int) -> None:
        self._f.seek(pos)

    def tell(self) -> int:
        return self._f.tell()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class LocalFileSystem(FileSystem):
    """Reference parity: ``src/io/local_filesys.cc :: LocalFileSystem``."""

    def open(self, uri: URI, mode: str) -> Stream:
        return _LocalFileStream(uri.name, mode)

    def get_path_info(self, uri: URI) -> FileInfo:
        st = os.stat(uri.name)
        ftype = "directory" if os.path.isdir(uri.name) else "file"
        return FileInfo(path=uri.protocol + uri.name if uri.protocol else uri.name,
                        size=st.st_size, type=ftype)

    def list_directory(self, uri: URI) -> List[FileInfo]:
        out = []
        for entry in os.listdir(uri.name):
            full = os.path.join(uri.name, entry)
            st = os.stat(full)
            ftype = "directory" if os.path.isdir(full) else "file"
            path = (uri.protocol + full) if uri.protocol else full
            out.append(FileInfo(path=path, size=st.st_size, type=ftype))
        return out


FS_REGISTRY.register("", entry=LocalFileSystem)
FS_REGISTRY.register("file://", entry=LocalFileSystem)


class MemoryFileSystem(FileSystem):
    """``mem://`` — an in-process filesystem for tests and small caches.

    Not in the reference (its tests used MemoryStringStream directly); here
    it also lets every URI-driven layer (splits, recordio, checkpoints) be
    exercised hermetically.
    """

    _files: Dict[str, bytearray] = {}

    def open(self, uri: URI, mode: str) -> Stream:
        from dmlc_core_tpu_torch.io.memory_io import MemoryStringStream

        key = uri.name
        if mode == "r":
            if key not in self._files:
                raise FileNotFoundError(f"mem://{key}")
            return MemoryStringStream(self._files[key])
        if mode == "w":
            # commit on close: a writer that dies (or aborts) mid-write
            # must not have destroyed the previous object — the same
            # atomicity the local backend gets from tmp + os.replace and
            # remote backends from their commit-on-close uploads
            files = self._files

            class _MemCommitStream(MemoryStringStream):
                def close(stream_self) -> None:  # noqa: N805
                    files[key] = stream_self.data

            return _MemCommitStream(bytearray())
        if mode == "a":
            buf = self._files.setdefault(key, bytearray())
            s = MemoryStringStream(buf)
            s.seek(len(buf))
            return s
        log_fatal(f"MemoryFileSystem: bad mode {mode!r}")

    def get_path_info(self, uri: URI) -> FileInfo:
        key = uri.name
        if key in self._files:
            return FileInfo(path="mem://" + key, size=len(self._files[key]), type="file")
        # directory if any file lives under it
        prefix = key.rstrip("/") + "/"
        if any(k.startswith(prefix) for k in self._files):
            return FileInfo(path="mem://" + key, size=0, type="directory")
        raise FileNotFoundError(f"mem://{key}")

    def list_directory(self, uri: URI) -> List[FileInfo]:
        prefix = uri.name.rstrip("/") + "/"
        out = []
        for k, v in self._files.items():
            if k.startswith(prefix) and "/" not in k[len(prefix):]:
                out.append(FileInfo(path="mem://" + k, size=len(v), type="file"))
        return out

    @classmethod
    def reset(cls) -> None:
        cls._files.clear()


FS_REGISTRY.register("mem://", entry=MemoryFileSystem)


class TemporaryDirectory:
    """RAII temp dir.  Reference parity: ``include/dmlc/filesystem.h ::
    TemporaryDirectory`` (mkdtemp + recursive delete) — the tests' main
    filesystem fixture."""

    def __init__(self, prefix: str = "dmlc"):
        self.path = tempfile.mkdtemp(prefix=prefix)

    def __enter__(self) -> "TemporaryDirectory":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def cleanup(self) -> None:
        if os.path.isdir(self.path):
            shutil.rmtree(self.path, ignore_errors=True)
