"""Azure Blob Storage backend (stdlib only).

Reference parity: ``src/io/azure_filesys.{h,cc} :: AzureFileSystem``
(SURVEY.md §2b — list/read in the reference; this adds writes too).

Auth: a SAS token (``AZURE_STORAGE_SAS``, appended to every URL) or
anonymous (public containers / fakes).  Shared-key signing is deliberately
not implemented — SAS is the recommended path and the reference's Azure
backend was similarly minimal.

Environment:
  AZURE_STORAGE_ACCOUNT — account name (default endpoint
                          ``https://<account>.blob.core.windows.net``)
  AZURE_BLOB_ENDPOINT   — endpoint override (fakes / azurite)
  AZURE_STORAGE_SAS     — SAS token ("sv=…&sig=…"), optional
"""

from __future__ import annotations

import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.io.filesystem import FS_REGISTRY, FileInfo, FileSystem, URI
from dmlc_core_tpu_torch.io.http_util import (
    BufferedWriteStream,
    HttpError,
    RangedReadStream,
    http_request,
)
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream

__all__ = ["AzureFileSystem"]


class _AzureWriteStream(BufferedWriteStream):
    """Put Block / Put Block List upload (parts stream out at part_size)."""

    def __init__(self, fs: "AzureFileSystem", container: str, blob: str,
                 part_size: int = 8 << 20):
        super().__init__(part_size=part_size)
        self._fs = fs
        self._container = container
        self._blob = blob
        self._block_ids: List[str] = []

    def _flush_part(self, part: bytes) -> None:
        bid = f"{len(self._block_ids):08d}"
        url = self._fs._url(self._container, self._blob,
                            f"comp=block&blockid={bid}")
        http_request("PUT", url, {}, part)
        self._block_ids.append(bid)

    def _finish(self, tail: bytes) -> None:
        if not self._block_ids:
            url = self._fs._url(self._container, self._blob)
            http_request("PUT", url, {"x-ms-blob-type": "BlockBlob"}, tail)
            return
        if tail:
            self._flush_part(tail)
        blocks = "".join(f"<Latest>{b}</Latest>" for b in self._block_ids)
        url = self._fs._url(self._container, self._blob, "comp=blocklist")
        http_request("PUT", url, {},
                     f"<BlockList>{blocks}</BlockList>".encode())


class AzureFileSystem(FileSystem):
    """``azure://container/blob`` backend."""

    def __init__(self) -> None:
        account = os.environ.get("AZURE_STORAGE_ACCOUNT", "")
        self._endpoint = os.environ.get(
            "AZURE_BLOB_ENDPOINT",
            f"https://{account}.blob.core.windows.net" if account else "")
        self._sas = os.environ.get("AZURE_STORAGE_SAS", "").lstrip("?")

    def _url(self, container: str, blob: str = "", query: str = "") -> str:
        CHECK(self._endpoint,
              "Azure: set AZURE_STORAGE_ACCOUNT or AZURE_BLOB_ENDPOINT")
        url = f"{self._endpoint.rstrip('/')}/{container}"
        if blob:
            url += "/" + urllib.parse.quote(blob.lstrip("/"), safe="/-_.~")
        params = [p for p in (query, self._sas) if p]
        if params:
            url += "?" + "&".join(params)
        return url

    # -- FileSystem interface --------------------------------------------
    def open(self, uri: URI, mode: str) -> Stream:
        CHECK(mode in ("r", "w"), f"Azure: mode {mode!r} not supported")
        container, blob = uri.host, uri.name.lstrip("/")
        if mode == "w":
            return _AzureWriteStream(self, container, blob)
        info = self.get_path_info(uri)
        return RangedReadStream(self._url(container, blob), info.size,
                                range_header="x-ms-range")

    def open_for_read(self, uri: URI) -> SeekStream:
        s = self.open(uri, "r")
        assert isinstance(s, SeekStream)
        return s

    def get_path_info(self, uri: URI) -> FileInfo:
        container, blob = uri.host, uri.name.lstrip("/")
        try:
            _, hdrs, _ = http_request("HEAD", self._url(container, blob))
            return FileInfo(path=f"azure://{container}/{blob}",
                            size=int(hdrs.get("content-length", 0)), type="file")
        except HttpError as e:
            if e.status != 404:
                raise
        if self._list(container, blob.rstrip("/") + "/", max_results=1,
                      max_pages=1):
            return FileInfo(path=f"azure://{container}/{blob}", size=0,
                            type="directory")
        raise FileNotFoundError(f"azure://{container}/{blob}")

    def _list(self, container: str, prefix: str,
              max_results: Optional[int] = None,
              max_pages: Optional[int] = None) -> List[FileInfo]:
        out: List[FileInfo] = []
        marker = ""
        pages = 0
        while True:
            q = (f"restype=container&comp=list&delimiter=%2F"
                 f"&prefix={urllib.parse.quote(prefix)}")
            if max_results:
                q += f"&maxresults={max_results}"
            if marker:
                q += f"&marker={urllib.parse.quote(marker)}"
            _, _, body = http_request("GET", self._url(container, query=q))
            root = ET.fromstring(body)
            for b in root.iter("Blob"):
                name = b.findtext("Name") or ""
                size = int(b.findtext("Properties/Content-Length") or 0)
                out.append(FileInfo(path=f"azure://{container}/{name}",
                                    size=size, type="file"))
            for p in root.iter("BlobPrefix"):
                name = (p.findtext("Name") or "").rstrip("/")
                if name:
                    out.append(FileInfo(path=f"azure://{container}/{name}",
                                        size=0, type="directory"))
            marker = root.findtext("NextMarker") or ""
            pages += 1
            if not marker or (max_pages is not None and pages >= max_pages):
                return out

    def list_directory(self, uri: URI) -> List[FileInfo]:
        prefix = uri.name.strip("/")
        return self._list(uri.host, prefix + "/" if prefix else "")


FS_REGISTRY.register("azure://", entry=AzureFileSystem)
