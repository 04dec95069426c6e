"""Kubernetes transport: one indexed Job per supervised worker.

Reuses :func:`dmlc_core_tpu_torch.tracker.kubernetes.build_manifest` — the
pure indexed-Job renderer the one-shot ``tracker/kubernetes.py`` backend
already ships — but under the :class:`~dmlc_core_tpu_torch.launch.transport.
Transport` interface, so the JobSet supervisor owns ranks, restarts and
teardown while k8s only runs pods.  Each spawned worker becomes a
single-completion Job named ``<jobname>-<label>`` whose pod carries the
env overlay verbatim (``backoffLimit`` 0: the JobSet's restart budget is
the ONE restart authority — double supervision would fork rank history).

**Dry-run by default**: without a cluster the transport renders and
records manifests (``self.manifests``) and reports every worker as
instantly completed, which is exactly what the manifest-snapshot tests
and ``dmlc-submit --dry-run`` consume.  With ``dry_run=False`` it shells
out to ``kubectl`` (apply / get -o json / delete / logs) — optional by
design; CI never needs a real cluster.
"""

from __future__ import annotations

import json
import re
import signal
import subprocess
from typing import Any, Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG
from dmlc_core_tpu_torch.launch.transport import (Transport, TransportError,
                                            WorkerHandle)
from dmlc_core_tpu_torch.tracker.kubernetes import build_manifest

__all__ = ["K8sTransport"]


def _job_name(jobname: str, label: str) -> str:
    """RFC-1123 label: lowercase alnum + '-', 63 chars."""
    raw = f"{jobname}-{label}".lower()
    raw = re.sub(r"[^a-z0-9-]+", "-", raw).strip("-")
    return raw[:63] or "dmlc-job"


class K8sTransport(Transport):
    """Spawn = render (and optionally ``kubectl apply``) one indexed Job.

    ``hosts()`` exposes one virtual ``k8s`` slot per expected worker —
    placement is the cluster scheduler's job, the slot list only sizes
    the JobSet's round-robin.
    """

    name = "k8s"

    def __init__(self, image: str, jobname: str = "dmlc-job",
                 namespace: Optional[str] = None,
                 kubectl: str = "kubectl", dry_run: bool = True,
                 worker_cores: Optional[int] = None,
                 worker_memory_mb: Optional[int] = None,
                 tpu_topology: Optional[str] = None,
                 tpu_accelerator: Optional[str] = None,
                 slots: int = 8):
        CHECK(bool(image), "K8sTransport needs a container image")
        self.image = image
        self.jobname = jobname
        self.namespace = namespace
        self.kubectl = kubectl
        self.dry_run = dry_run
        self.worker_cores = worker_cores
        self.worker_memory_mb = worker_memory_mb
        self.tpu_topology = tpu_topology
        self.tpu_accelerator = tpu_accelerator
        self._slots = max(1, int(slots))
        #: every manifest rendered by this transport, in spawn order —
        #: the dry-run evidence the snapshot tests assert on
        self.manifests: List[Dict[str, Any]] = []

    def hosts(self) -> List[str]:
        return ["k8s"] * self._slots

    def render(self, command: List[str], env: Dict[str, str],
               label: str) -> Dict[str, Any]:
        """The manifest for one worker (pure — no cluster contact)."""
        return build_manifest(
            1, command, env, self.image,
            jobname=_job_name(self.jobname, label),
            worker_cores=self.worker_cores,
            worker_memory_mb=self.worker_memory_mb,
            max_attempts=0,     # completions=1, backoffLimit=0: the
            tpu_topology=self.tpu_topology,          # JobSet restarts
            tpu_accelerator=self.tpu_accelerator)

    def _kubectl(self, *args: str, input_text: Optional[str] = None
                 ) -> subprocess.CompletedProcess:
        argv = [self.kubectl]
        if self.namespace:
            argv += ["-n", self.namespace]
        argv += list(args)
        return subprocess.run(argv, input=input_text, text=True,
                              capture_output=True)

    def spawn(self, command: List[str], env: Dict[str, str],
              host: str, label: str = "worker") -> WorkerHandle:
        manifest = self.render(command, env, label)
        self.manifests.append(manifest)
        job = manifest["metadata"]["name"]
        handle = WorkerHandle(host, label, env,
                              extra={"job": job, "manifest": manifest})
        if self.dry_run:
            # rendered == done: dry-run proves the configuration, it
            # does not simulate pod lifetimes
            handle.extra["exit_code"] = 0
            return handle
        p = self._kubectl("apply", "-f", "-",
                          input_text=json.dumps(manifest))
        if p.returncode != 0:
            raise TransportError(
                f"kubectl apply failed for job {job}: {p.stderr.strip()}")
        LOG("INFO", "k8s transport: applied job %s", job)
        return handle

    def poll(self, handle: WorkerHandle) -> Optional[int]:
        if "exit_code" in handle.extra:
            return int(handle.extra["exit_code"])  # type: ignore[arg-type]
        p = self._kubectl("get", "job", str(handle.extra["job"]),
                          "-o", "json")
        if p.returncode != 0:
            return None         # API blip: stay optimistic, poll again
        try:
            status = json.loads(p.stdout).get("status", {})
        except ValueError:
            return None
        if int(status.get("succeeded") or 0) >= 1:
            handle.extra["exit_code"] = 0
            return 0
        if int(status.get("failed") or 0) >= 1:
            handle.extra["exit_code"] = 1
            return 1
        return None

    def signal(self, handle: WorkerHandle, sig: int) -> None:
        # k8s has no per-signal channel: any kill-ish signal deletes the
        # Job (foreground propagation SIGTERMs the pod)
        if sig not in (signal.SIGTERM, signal.SIGKILL, signal.SIGINT):
            return
        if "exit_code" in handle.extra:
            return
        if self.dry_run:
            handle.extra["exit_code"] = 128 + int(sig)
            return
        self._kubectl("delete", "job", str(handle.extra["job"]),
                      "--ignore-not-found=true", "--wait=false")
        handle.extra["exit_code"] = 128 + int(sig)

    def log_tail(self, handle: WorkerHandle, max_bytes: int = 4096) -> str:
        if self.dry_run:
            return ""
        p = self._kubectl("logs", f"job/{handle.extra['job']}",
                          "--tail", "100")
        return p.stdout[-max_bytes:] if p.returncode == 0 else ""
