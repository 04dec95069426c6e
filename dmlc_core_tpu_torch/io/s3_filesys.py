"""S3 filesystem backend over AWS Signature V4 (stdlib only).

Reference parity: ``src/io/s3_filesys.{h,cc} :: S3FileSystem`` (SURVEY.md
§2b) — HMAC request signing, ListObjects paging, ranged reads, multipart
writes.  The reference signed with SigV2 (HMAC-SHA1 + libcurl); this
implementation uses the current SigV4 scheme and stdlib HTTP.

Environment (reference-compatible where it existed):
  AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY  — credentials (empty = anonymous)
  S3_REGION     — default ``us-east-1``
  S3_ENDPOINT   — override endpoint (e.g. an in-process fake or minio);
                  implies path-style addressing
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
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

__all__ = ["S3FileSystem", "sigv4_headers"]

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(
    method: str,
    url: str,
    headers: Dict[str, str],
    payload: bytes,
    access_key: str,
    secret_key: str,
    region: str,
    service: str = "s3",
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """AWS Signature Version 4 for one request → headers incl. Authorization.

    Pure function (``now`` injectable) so the canonical-request math is
    testable against the published AWS test vectors.
    """
    parsed = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest() if payload else _EMPTY_SHA256

    out = dict(headers)
    out["host"] = parsed.netloc
    out["x-amz-date"] = amz_date
    if service == "s3":  # S3 requires the payload hash header; others don't
        out["x-amz-content-sha256"] = payload_hash

    signed_names = sorted(k.lower() for k in out)
    canonical_headers = "".join(
        f"{k}:{out[next(h for h in out if h.lower() == k)].strip()}\n"
        for k in signed_names
    )
    signed_headers = ";".join(signed_names)
    # canonical query: sorted, URI-encoded
    query_pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query_pairs)
    )
    canonical_request = "\n".join([
        method,
        parsed.path or "/",  # already percent-encoded by the caller; S3
                             # signs the single-encoded form verbatim
        canonical_query,
        canonical_headers,
        signed_headers,
        payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256",
        amz_date,
        scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k_date = _hmac(b"AWS4" + secret_key.encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    del out["host"]  # urllib sets Host itself; it was only needed for signing
    return out


class _S3WriteStream(BufferedWriteStream):
    """Multipart upload writer (reference: ``s3_filesys.cc :: WriteStream``).

    Parts stream out at ``part_size`` (S3 minimum 5 MiB); small objects fall
    back to a single PUT.
    """

    def __init__(self, fs: "S3FileSystem", bucket: str, key: str,
                 part_size: int = 8 << 20):
        super().__init__(part_size=part_size)
        self._fs = fs
        self._bucket = bucket
        self._key = key
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []

    def _start_multipart(self) -> None:
        url = self._fs._object_url(self._bucket, self._key) + "?uploads="
        # initiate is retry-safe for ambiguous failures too: a duplicate
        # initiate merely leaks an upload id S3 will age out
        _, _, body = self._fs._request("POST", url, idempotent=True)
        self._upload_id = ET.fromstring(body).findtext(
            "{*}UploadId") or ET.fromstring(body).findtext("UploadId")
        CHECK(self._upload_id, "S3: no UploadId in InitiateMultipartUpload reply")

    def _flush_part(self, part: bytes) -> None:
        if self._upload_id is None:
            self._start_multipart()
        n = len(self._etags) + 1
        url = (self._fs._object_url(self._bucket, self._key)
               + f"?partNumber={n}&uploadId={self._upload_id}")
        _, hdrs, _ = self._fs._request("PUT", url, body=part)
        self._etags.append(hdrs.get("etag", f'"{n}"'))

    def _finish(self, tail: bytes) -> None:
        if self._upload_id is None:
            # small object: single PUT
            self._fs._request(
                "PUT", self._fs._object_url(self._bucket, self._key), body=tail)
            return
        if tail:
            self._flush_part(tail)
        parts = "".join(
            f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
            for i, e in enumerate(self._etags))
        xml_body = (f"<CompleteMultipartUpload>{parts}"
                    f"</CompleteMultipartUpload>").encode()
        url = (self._fs._object_url(self._bucket, self._key)
               + f"?uploadId={self._upload_id}")
        self._fs._request("POST", url, body=xml_body)


class S3FileSystem(FileSystem):
    """``s3://bucket/key`` backend."""

    def __init__(self) -> None:
        self._access = os.environ.get("AWS_ACCESS_KEY_ID", "")
        self._secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self._region = os.environ.get("S3_REGION", "us-east-1")
        self._endpoint = os.environ.get("S3_ENDPOINT", "")

    # -- request plumbing ------------------------------------------------
    def _object_url(self, bucket: str, key: str) -> str:
        key = urllib.parse.quote(key.lstrip("/"), safe="/-_.~")
        if self._endpoint:  # path-style (fakes, minio)
            return f"{self._endpoint.rstrip('/')}/{bucket}/{key}"
        return f"https://{bucket}.s3.{self._region}.amazonaws.com/{key}"

    def _bucket_url(self, bucket: str, query: str) -> str:
        if self._endpoint:
            return f"{self._endpoint.rstrip('/')}/{bucket}?{query}"
        return f"https://{bucket}.s3.{self._region}.amazonaws.com/?{query}"

    def _sign(self, method: str, url: str, headers: Dict[str, str],
              payload: bytes) -> Dict[str, str]:
        if not self._access:
            return headers  # anonymous (fakes/public buckets)
        return sigv4_headers(method, url, headers, payload,
                             self._access, self._secret, self._region)

    def _request(self, method: str, url: str, headers: Optional[Dict[str, str]] = None,
                 body: bytes = b"", **kw):
        return http_request(method, url, self._sign(method, url, headers or {}, body),
                            body, **kw)

    # -- FileSystem interface --------------------------------------------
    def open(self, uri: URI, mode: str) -> Stream:
        CHECK(mode in ("r", "w"), f"S3: mode {mode!r} not supported (no append)")
        bucket, key = uri.host, uri.name.lstrip("/")
        if mode == "w":
            return _S3WriteStream(self, bucket, key)
        info = self.get_path_info(uri)
        return RangedReadStream(self._object_url(bucket, key), info.size,
                                sign=self._sign)

    def open_for_read(self, uri: URI) -> SeekStream:
        s = self.open(uri, "r")
        assert isinstance(s, SeekStream)
        return s

    def get_path_info(self, uri: URI) -> FileInfo:
        bucket, key = uri.host, uri.name.lstrip("/")
        url = self._object_url(bucket, key)
        try:
            _, hdrs, _ = http_request(
                "HEAD", url, self._sign("HEAD", url, {}, b""))
            return FileInfo(path=f"s3://{bucket}/{key}",
                            size=int(hdrs.get("content-length", 0)), type="file")
        except HttpError as e:
            if e.status != 404:
                raise
        # not an object → directory if any key or sub-prefix lives under it
        files, prefixes = self._list(bucket, key.rstrip("/") + "/", max_keys=1,
                                     max_pages=1)
        if files or prefixes:
            return FileInfo(path=f"s3://{bucket}/{key}", size=0, type="directory")
        raise FileNotFoundError(f"s3://{bucket}/{key}")

    def _list(self, bucket: str, prefix: str, max_keys: int = 1000,
              max_pages: Optional[int] = None
              ) -> Tuple[List[Tuple[str, int]], List[str]]:
        """ListObjectsV2 with paging → ([(key, size)], [common prefixes]).

        ``max_pages`` caps the round trips (existence probes need one)."""
        out: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        token = ""
        pages = 0
        while True:
            query = ("list-type=2&delimiter=%2F"
                     f"&prefix={urllib.parse.quote(prefix)}&max-keys={max_keys}")
            if token:
                query += f"&continuation-token={urllib.parse.quote(token)}"
            url = self._bucket_url(bucket, query)
            _, _, body = http_request(
                "GET", url, self._sign("GET", url, {}, b""))
            root = ET.fromstring(body)
            ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
            for item in root.iter(f"{ns}Contents"):
                k = item.findtext(f"{ns}Key") or ""
                size = int(item.findtext(f"{ns}Size") or 0)
                out.append((k, size))
            for item in root.iter(f"{ns}CommonPrefixes"):
                p = item.findtext(f"{ns}Prefix")
                if p:
                    prefixes.append(p)
            token = root.findtext(f"{ns}NextContinuationToken") or ""
            pages += 1
            if not token or (max_pages is not None and pages >= max_pages):
                return out, prefixes

    def list_directory(self, uri: URI) -> List[FileInfo]:
        bucket = uri.host
        prefix = uri.name.strip("/")
        prefix = prefix + "/" if prefix else ""
        out = []
        files, prefixes = self._list(bucket, prefix)
        for key, size in files:
            if key == prefix:
                continue
            out.append(FileInfo(path=f"s3://{bucket}/{key}", size=size, type="file"))
        for p in prefixes:
            out.append(FileInfo(path=f"s3://{bucket}/{p.rstrip('/')}", size=0,
                                type="directory"))
        return out


FS_REGISTRY.register("s3://", entry=S3FileSystem)
