"""Google Cloud Storage backend (stdlib only).

Not in the reference (it had S3/HDFS/Azure, SURVEY.md §2b); the JAX
package added it, and this is the port's copy.  Uses the JSON API with a
bearer token.

Environment:
  GCS_TOKEN    — OAuth2 bearer token (e.g. from metadata server / gcloud);
                 empty = anonymous (public buckets / fakes)
  GCS_ENDPOINT — endpoint override (default ``https://storage.googleapis.com``)
"""

from __future__ import annotations

import json
import os
import urllib.parse
from typing import Dict, List, Optional, Tuple

from dmlc_core_tpu_torch.base.logging import CHECK
from dmlc_core_tpu_torch.io.filesystem import FS_REGISTRY, FileInfo, FileSystem, URI
from dmlc_core_tpu_torch.io.http_util import (
    BufferedWriteStream,
    HttpError,
    RangedReadStream,
    http_request,
)
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream

__all__ = ["GCSFileSystem"]


class _GCSWriteStream(BufferedWriteStream):
    """Simple (single-request) media upload on close."""

    def __init__(self, fs: "GCSFileSystem", bucket: str, obj: str):
        super().__init__(part_size=0)
        self._fs = fs
        self._bucket = bucket
        self._obj = obj

    def _commit(self, data: bytes) -> None:
        url = (f"{self._fs._endpoint}/upload/storage/v1/b/{self._bucket}/o"
               f"?uploadType=media&name={urllib.parse.quote(self._obj, safe='')}")
        # media upload replaces the whole object — retrying an ambiguous
        # failure re-uploads the identical bytes, so opt in to retries
        http_request("POST", url,
                     self._fs._auth({"Content-Type": "application/octet-stream"}),
                     data, idempotent=True)


class GCSFileSystem(FileSystem):
    """``gs://bucket/object`` backend."""

    def __init__(self) -> None:
        self._endpoint = os.environ.get(
            "GCS_ENDPOINT", "https://storage.googleapis.com").rstrip("/")
        self._token = os.environ.get("GCS_TOKEN", "")

    def _auth(self, headers: Dict[str, str]) -> Dict[str, str]:
        if self._token:
            headers = dict(headers)
            headers["Authorization"] = f"Bearer {self._token}"
        return headers

    def _media_url(self, bucket: str, obj: str) -> str:
        return (f"{self._endpoint}/download/storage/v1/b/{bucket}/o/"
                f"{urllib.parse.quote(obj, safe='')}?alt=media")

    def _meta_url(self, bucket: str, obj: str) -> str:
        return (f"{self._endpoint}/storage/v1/b/{bucket}/o/"
                f"{urllib.parse.quote(obj, safe='')}")

    # -- FileSystem interface --------------------------------------------
    def open(self, uri: URI, mode: str) -> Stream:
        CHECK(mode in ("r", "w"), f"GCS: mode {mode!r} not supported")
        bucket, obj = uri.host, uri.name.lstrip("/")
        if mode == "w":
            return _GCSWriteStream(self, bucket, obj)
        info = self.get_path_info(uri)
        # bearer auth must ride every ranged request
        def sign(method, url, headers, payload):
            return self._auth(headers)
        return RangedReadStream(self._media_url(bucket, obj), info.size,
                                sign=sign)

    def open_for_read(self, uri: URI) -> SeekStream:
        s = self.open(uri, "r")
        assert isinstance(s, SeekStream)
        return s

    def get_path_info(self, uri: URI) -> FileInfo:
        bucket, obj = uri.host, uri.name.lstrip("/")
        try:
            _, _, body = http_request("GET", self._meta_url(bucket, obj),
                                      self._auth({}))
            meta = json.loads(body)
            return FileInfo(path=f"gs://{bucket}/{obj}",
                            size=int(meta.get("size", 0)), type="file")
        except HttpError as e:
            if e.status != 404:
                raise
        files, prefixes = self._list(bucket, obj.rstrip("/") + "/",
                                     max_results=1, max_pages=1)
        if files or prefixes:
            return FileInfo(path=f"gs://{bucket}/{obj}", size=0, type="directory")
        raise FileNotFoundError(f"gs://{bucket}/{obj}")

    def _list(self, bucket: str, prefix: str, max_results: int = 1000,
              max_pages: Optional[int] = None
              ) -> Tuple[List[FileInfo], List[str]]:
        out: List[FileInfo] = []
        prefixes: List[str] = []
        token = ""
        pages = 0
        while True:
            url = (f"{self._endpoint}/storage/v1/b/{bucket}/o"
                   f"?prefix={urllib.parse.quote(prefix)}&delimiter=%2F"
                   f"&maxResults={max_results}")
            if token:
                url += f"&pageToken={urllib.parse.quote(token)}"
            _, _, body = http_request("GET", url, self._auth({}))
            data = json.loads(body)
            for item in data.get("items", []):
                out.append(FileInfo(path=f"gs://{bucket}/{item['name']}",
                                    size=int(item.get("size", 0)), type="file"))
            prefixes.extend(data.get("prefixes", []))
            token = data.get("nextPageToken", "")
            pages += 1
            if not token or (max_pages is not None and pages >= max_pages):
                return out, prefixes

    def list_directory(self, uri: URI) -> List[FileInfo]:
        prefix = uri.name.strip("/")
        files, prefixes = self._list(uri.host, prefix + "/" if prefix else "")
        files.extend(
            FileInfo(path=f"gs://{uri.host}/{p.rstrip('/')}", size=0,
                     type="directory") for p in prefixes)
        return files


FS_REGISTRY.register("gs://", entry=GCSFileSystem)
