"""HDFS filesystem backend over the WebHDFS REST API (stdlib only).

Reference parity: ``src/io/hdfs_filesys.{h,cc} :: HDFSFileSystem``
(SURVEY.md §2b).  The reference used libhdfs JNI (an in-process JVM);
this build talks WebHDFS REST instead — no JVM on the worker hosts, and
the protocol is testable against an in-process fake namenode.

Environment:
  DMLC_HDFS_NAMENODE — namenode HTTP address (e.g. ``http://nn:9870``);
                       required (there is no default cluster).
  DMLC_HDFS_USER     — value for ``user.name`` (default: $USER).

Handles ``hdfs://host:port/path`` and ``viewfs://…`` URIs; an explicit
host:port in the URI overrides the env namenode.
"""

from __future__ import annotations

import json
import os
import urllib.parse
from typing import List

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.io.filesystem import FS_REGISTRY, FileInfo, FileSystem, URI
from dmlc_core_tpu_torch.io.http_util import BufferedWriteStream, RangedReadStream, http_request
from dmlc_core_tpu_torch.io.stream import Stream

__all__ = ["HDFSFileSystem"]


class _WebHDFSReadStream(RangedReadStream):
    """WebHDFS OPEN uses ``offset``/``length`` query params, not Range."""

    def _fetch(self, pos: int, nbytes: int) -> bytes:
        url = f"{self._url}&offset={pos}&length={nbytes}"
        _, _, data = http_request("GET", url)
        return data[:nbytes]


class _WebHDFSWriteStream(BufferedWriteStream):
    """CREATE once, then APPEND parts (both via the two-step redirect)."""

    def __init__(self, fs: "HDFSFileSystem", path: str, host: str = "",
                 part_size: int = 8 << 20):
        super().__init__(part_size=part_size)
        self._fs = fs
        self._path = path
        self._host = host
        self._created = False

    def _two_step(self, method: str, op: str, data: bytes) -> None:
        # retry safety per step: the namenode round trip only mints a
        # redirect (no data applied) so it is retryable for any method;
        # the datanode step inherits method semantics — CREATE is a PUT
        # (idempotent, overwrite=true), APPEND is a POST and must NOT
        # retry ambiguous transport failures (a double-append corrupts),
        # though explicit 5xx rejections still retry.
        url = self._fs._op_url(self._path, op, self._host)
        status, hdrs, _ = http_request(method, url, follow_redirects=False,
                                       ok=(200, 201, 307), idempotent=True)
        if 300 <= status < 400:  # namenode redirects to a datanode
            url = hdrs["location"]
        http_request(method, url, {"Content-Type": "application/octet-stream"},
                     data)

    def _flush_part(self, part: bytes) -> None:
        if not self._created:
            self._two_step("PUT", "CREATE&overwrite=true", part)
            self._created = True
        else:
            self._two_step("POST", "APPEND", part)

    def _finish(self, tail: bytes) -> None:
        if not self._created or tail:
            self._flush_part(tail)


class HDFSFileSystem(FileSystem):
    """``hdfs://`` / ``viewfs://`` backend via WebHDFS."""

    def __init__(self) -> None:
        self._namenode = os.environ.get("DMLC_HDFS_NAMENODE", "")
        self._user = os.environ.get("DMLC_HDFS_USER", os.environ.get("USER", ""))

    def _base(self, uri_host: str) -> str:
        if uri_host:
            return f"http://{uri_host}"
        CHECK(self._namenode, "HDFS: set DMLC_HDFS_NAMENODE or use hdfs://host:port/…")
        return self._namenode.rstrip("/")

    def _op_url(self, path: str, op: str, host: str = "") -> str:
        q = f"op={op}"
        if self._user:
            q += f"&user.name={urllib.parse.quote(self._user)}"
        return (f"{self._base(host)}/webhdfs/v1"
                f"{urllib.parse.quote(path, safe='/-_.~')}?{q}")

    # -- FileSystem interface --------------------------------------------
    def open(self, uri: URI, mode: str) -> Stream:
        CHECK(mode in ("r", "w", "a"), f"HDFS: bad mode {mode!r}")
        if mode == "r":
            info = self.get_path_info(uri)
            return _WebHDFSReadStream(self._op_url(uri.name, "OPEN", uri.host),
                                      info.size)
        ws = _WebHDFSWriteStream(self, uri.name, uri.host)
        if mode == "a":
            ws._created = True  # append to existing file
        return ws

    def get_path_info(self, uri: URI) -> FileInfo:
        url = self._op_url(uri.name, "GETFILESTATUS", uri.host)
        try:
            _, _, body = http_request("GET", url)
        except IOError as e:
            raise FileNotFoundError(f"hdfs://{uri.host}{uri.name}: {e}") from e
        st = json.loads(body)["FileStatus"]
        return FileInfo(
            path=f"hdfs://{uri.host}{uri.name}",
            size=int(st.get("length", 0)),
            type="directory" if st.get("type") == "DIRECTORY" else "file",
        )

    def list_directory(self, uri: URI) -> List[FileInfo]:
        url = self._op_url(uri.name, "LISTSTATUS", uri.host)
        _, _, body = http_request("GET", url)
        statuses = json.loads(body)["FileStatuses"]["FileStatus"]
        base = uri.name.rstrip("/")
        out = []
        for st in statuses:
            name = st.get("pathSuffix", "")
            path = f"{base}/{name}" if name else base
            out.append(FileInfo(
                path=f"hdfs://{uri.host}{path}",
                size=int(st.get("length", 0)),
                type="directory" if st.get("type") == "DIRECTORY" else "file",
            ))
        return out


FS_REGISTRY.register("hdfs://", entry=HDFSFileSystem)
FS_REGISTRY.register("viewfs://", entry=HDFSFileSystem)
