"""Plain HTTP(S) read-only filesystem backend.

Gives ``Stream.create("https://host/path", "r")`` and HTTP-hosted input
splits for public datasets.  The reference gated remote access behind
bucket stores; a generic HTTP backend is the zero-auth counterpart —
size comes from a HEAD request and reads are ranged GETs through
:class:`~dmlc_core_tpu_torch.io.http_util.RangedReadStream` (servers without
Range support would corrupt reads, so a 200-to-Range probe fatals).
Write/list are unsupported by the protocol and raise.
"""

from __future__ import annotations

from typing import List

from dmlc_core_tpu_torch.base.logging import log_fatal
from dmlc_core_tpu_torch.io.filesystem import FS_REGISTRY, FileInfo, FileSystem, URI
from dmlc_core_tpu_torch.io.http_util import (
    HttpError,
    RangedReadStream,
    http_probe_range,
    http_request,
)
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream

__all__ = ["HttpFileSystem"]


class HttpFileSystem(FileSystem):
    """Read-only backend for ``http://`` and ``https://`` URIs."""

    def __init__(self) -> None:
        # per-instance stat cache: InputSplit lists files then opens each
        # through the SAME instance — without this every open re-issues
        # the HEAD (+ probe) the listing just paid for
        self._info_cache: dict = {}

    def _url(self, uri: URI) -> str:
        return uri.protocol + uri.host + uri.name

    def open(self, uri: URI, mode: str) -> Stream:
        if mode != "r":
            log_fatal(f"http filesystem is read-only (mode {mode!r})")
        return self.open_for_read(uri)

    def open_for_read(self, uri: URI) -> SeekStream:
        url = self._url(uri)
        info = self.get_path_info(uri)
        return RangedReadStream(url, info.size)

    def get_path_info(self, uri: URI) -> FileInfo:
        url = self._url(uri)
        cached = self._info_cache.get(url)
        if cached is not None:
            return cached
        try:
            status, headers, _ = http_request("HEAD", url)
        except HttpError as e:
            raise IOError(f"HEAD {url} failed: {e}") from e
        size = int(headers.get("content-length", -1))
        if size < 0:
            log_fatal(f"http: {url} has no Content-Length — cannot do "
                      "ranged reads")
        if headers.get("accept-ranges", "").lower() != "bytes":
            # header absent ≠ unsupported: probe with a status-only 1-byte
            # Range GET (body never read).  A server that ignores Range
            # would make RangedReadStream re-download the whole object per
            # readahead window, so fail fast instead
            if not http_probe_range(url):
                log_fatal(f"http: {url} ignores Range requests — "
                          "streaming reads would re-download the object")
        info = FileInfo(path=url, size=size, type="file")
        self._info_cache[url] = info
        return info

    def list_directory(self, uri: URI) -> List[FileInfo]:
        log_fatal("http filesystem cannot list directories")

    def list_directory_ex(self, uri: URI) -> List[FileInfo]:
        # no glob interpretation: '?' in an HTTP URL is a query string,
        # not a wildcard, and HTTP cannot list anyway — a URI here must
        # name exactly one object
        return [self.get_path_info(uri)]


FS_REGISTRY.register("http://", entry=HttpFileSystem)
FS_REGISTRY.register("https://", entry=HttpFileSystem)
