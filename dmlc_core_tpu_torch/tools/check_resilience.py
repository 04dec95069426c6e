#!/usr/bin/env python
"""Fault-injection smoke: checkpoint kill-and-recover and a lossy-wire S3
round trip.

    python -m dmlc_core_tpu_torch.tools.check_resilience

The port of ``scripts/check_resilience.py``.  Two drills, both
deterministic, on the host (numpy state and an S3 fake; no device):

1. **Checkpoint kill-and-recover** — a child process saves checkpoint v2
   over an existing v1 with ``DMLC_FAULT_INJECT=checkpoint:kill`` active,
   so it is SIGKILLed between payload write and commit.  The parent then
   proves the atomic-write contract: the checkpoint on disk still loads
   as v1, bit-identical.  A corrupt-and-fall-back pass (flip a byte in a
   committed v2, load → the retained v1) rides along.
2. **Lossy-wire S3 round trip** — an in-process fake S3 server plus
   ``http:error=503:p=0.35,stream:truncate:p=0.2`` injection; a
   multipart write and a ranged read must come back byte-identical, with
   nonzero ``dmlc_retries_total`` and fired faults as evidence that the
   chaos happened.

The parent and its writer children run under ``DMLC_LOCKCHECK=1``,
``DMLC_RACECHECK=1`` and ``DMLC_LEAKCHECK=1``; GREEN needs zero
lock-order cycles, races and live leaks (reports at
``RESILIENCE_RACECHECK_OUT`` / ``RESILIENCE_LEAKCHECK_OUT``).  Merged
metrics at ``RESILIENCE_METRICS_OUT``.  Exit 0 = both drills green.
``--writer URI VERSION`` is the child's entry.
"""

import os
import signal
import subprocess
import sys
import tempfile
import threading
import urllib.parse

import numpy as np

from dmlc_core_tpu_torch.tools._drill import (check, gate_checkers,
                                              install_checkers, out)



def _state(version):
    rng = np.random.default_rng(version)
    return {"w": rng.standard_normal(512).astype(np.float32),
            "round": version * 10}


def writer_main(uri, version):
    """Child entry: save one checkpoint (the parent may have armed
    DMLC_FAULT_INJECT to SIGKILL it mid-write)."""
    from dmlc_core_tpu_torch.base import lockcheck, metrics_agg
    from dmlc_core_tpu_torch.parallel.checkpoint import checkpoint

    metrics_agg.install_spool("ckpt_writer", version)
    checkpoint(uri, _state(version), version=version)
    lockcheck.check()


def drill_checkpoint(tmpdir):
    from dmlc_core_tpu_torch.parallel.checkpoint import load_checkpoint

    uri = os.path.join(tmpdir, "ck")
    like = _state(0)

    def run_writer(version, fault=""):
        env = dict(os.environ, DMLC_FAULT_INJECT=fault)
        return subprocess.run(
            [sys.executable, "-m", "dmlc_core_tpu_torch.tools.check_resilience",
             "--writer", uri, str(version)], env=env, capture_output=True,
            text=True, timeout=300)

    r = run_writer(1)
    check(r.returncode == 0, f"clean v1 save (rc={r.returncode}) "
                              f"{r.stderr[-2000:] if r.returncode else ''}")
    v, st = load_checkpoint(uri, like)
    check(v == 1 and np.array_equal(st["w"], _state(1)["w"]),
           "v1 loads back bit-identical")

    # kill mid-write of v2: the injector SIGKILLs the child between
    # payload write and commit
    r = run_writer(2, fault="checkpoint:kill")
    check(r.returncode == -signal.SIGKILL,
           f"v2 writer was SIGKILLed mid-write (rc={r.returncode})")
    v, st = load_checkpoint(uri, like)
    check(v == 1 and np.array_equal(st["w"], _state(1)["w"]),
           "post-kill load still serves v1 bit-identical")

    # commit v2 for real, corrupt it, load must fall back to v1
    r = run_writer(2)
    check(r.returncode == 0, "clean v2 save")
    v, _ = load_checkpoint(uri, like)
    check(v == 2, "v2 visible after clean save")
    with open(uri, "r+b") as f:
        size = os.path.getsize(uri)
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    v, st = load_checkpoint(uri, like)
    check(v == 1 and np.array_equal(st["w"], _state(1)["w"]),
           "corrupt v2 falls back to retained v1")


class _FakeS3:
    """A minimal S3 fake (objects and multipart) for the lossy-wire
    drill."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        store, uploads = {}, {}

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, body=b"", headers=None):
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _key(self):
                p = urllib.parse.urlsplit(self.path)
                return urllib.parse.unquote(p.path.lstrip("/")), dict(
                    urllib.parse.parse_qsl(p.query, keep_blank_values=True))

            def do_HEAD(self):  # noqa: N802
                key, _ = self._key()
                if key in store:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(store[key])))
                    self.end_headers()
                else:
                    self._send(404)

            def do_GET(self):  # noqa: N802
                key, _ = self._key()
                blob = store.get(key)
                if blob is None:
                    self._send(404)
                    return
                rng = self.headers.get("Range")
                if rng:
                    lo, _, hi = rng.split("=")[1].partition("-")
                    lo = int(lo)
                    hi = int(hi) if hi else len(blob) - 1
                    self._send(206, blob[lo:hi + 1])
                else:
                    self._send(200, blob)

            def do_PUT(self):  # noqa: N802
                key, q = self._key()
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if "partNumber" in q:
                    uploads.setdefault(q["uploadId"], {})[
                        int(q["partNumber"])] = body
                    self._send(200, b"", {"ETag": f'"p{q["partNumber"]}"'})
                    return
                store[key] = body
                self._send(200)

            def do_POST(self):  # noqa: N802
                key, q = self._key()
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                if "uploads" in q:
                    uid = f"up{len(uploads)}"
                    uploads[uid] = {}
                    self._send(200, (
                        f"<InitiateMultipartUploadResult><UploadId>{uid}"
                        f"</UploadId></InitiateMultipartUploadResult>"
                    ).encode())
                    return
                if "uploadId" in q:
                    parts = uploads.pop(q["uploadId"])
                    store[key] = b"".join(parts[i] for i in sorted(parts))
                    self._send(200, b"<CompleteMultipartUploadResult/>")
                    return
                self._send(400)

        self.store = store
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.endpoint = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)


def drill_lossy_wire():
    # at p=0.35 a 4-attempt budget still loses ~1.5% of requests; give
    # the drill the headroom a real lossy-wire deployment would tune in
    os.environ["DMLC_RETRY_MAX_ATTEMPTS"] = "10"
    os.environ["DMLC_RETRY_BASE_S"] = "0.005"
    os.environ.pop("AWS_ACCESS_KEY_ID", None)
    fake = _FakeS3()
    os.environ["S3_ENDPOINT"] = fake.endpoint

    from dmlc_core_tpu_torch.base import faultinject as fi
    from dmlc_core_tpu_torch.base.metrics import default_registry
    from dmlc_core_tpu_torch.io.stream import Stream

    try:
        payload = np.random.default_rng(0).bytes(18 << 20)  # > 2 parts
        with fi.inject("http:error=503:p=0.35,stream:truncate:p=0.2",
                       seed=11):
            with Stream.create("s3://bkt/blob.bin", "w") as s:
                s.write(payload)
            with Stream.create("s3://bkt/blob.bin", "r") as s:
                got = s.read_all()
            faults = fi.fired_total()
    finally:
        fake.close()
    check(got == payload,
           "multipart write + ranged read byte-identical under faults")
    check(faults > 0, f"faults actually fired ({faults})")
    retries = default_registry().counter("retries_total", labels=("op",))
    total = sum(s["value"] for s in retries._snap())
    check(total > 0, f"retries recorded on the registry ({total})")


def main():
    if len(sys.argv) >= 2 and sys.argv[1] == "--writer":
        writer_main(sys.argv[2], int(sys.argv[3]))
        return
    install_checkers()
    # observability plane: the parent and its writer children spool
    # metrics snapshots into one directory (children inherit the env)
    spool = os.environ.get("DMLC_METRICS_SPOOL") \
        or tempfile.mkdtemp(prefix="dmlc_resilience_spool")
    os.environ["DMLC_METRICS_SPOOL"] = spool
    from dmlc_core_tpu_torch.base import metrics_agg

    spool_writer = metrics_agg.install_spool("drill", 0)
    with tempfile.TemporaryDirectory(prefix="dmlc_resilience") as tmpdir:
        drill_checkpoint(tmpdir)
    drill_lossy_wire()
    if spool_writer is not None:
        spool_writer.close()
    merged, nprocs = metrics_agg.merge_spool(spool)
    metrics_out = out("RESILIENCE_METRICS_OUT", "resilience_metrics.json")
    metrics_agg.write_snapshot(metrics_out, merged)
    check(nprocs >= 2, f"metrics spool merged {nprocs} processes "
                        f"(artifact at {metrics_out})")
    gate_checkers("RESILIENCE")
    print("RESILIENCE SMOKE GREEN")


if __name__ == "__main__":
    main()
