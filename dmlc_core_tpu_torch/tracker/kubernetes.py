"""Kubernetes launch backend.

Reference parity: ``tracker/dmlc_tracker/kubernetes.py`` (SURVEY.md §2c) —
and the idiomatic TPU-pod launcher: GKE is how TPU slices are scheduled in
practice.  Generates an indexed Job manifest (one pod per worker, the
``DMLC_*`` env ABI injected, ``JOB_COMPLETION_INDEX`` → ``DMLC_TASK_ID``)
and applies it with kubectl.  Pod restart policy carries the reference's
YARN-AM restart semantics (``ApplicationMaster.java`` max-attempt
container restarts → ``backoffLimit``; restarted workers see
``DMLC_NUM_ATTEMPT`` through the tracker ``recover`` path).

This package's own copy of the JAX package's backend: the same manifest
for the same arguments, the TPU-slice nodeSelector arguments included.
"""

from __future__ import annotations

import json
import subprocess
from typing import Any, Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import CHECK, LOG

__all__ = ["build_manifest", "launch"]


def build_manifest(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    image: str,
    jobname: str = "dmlc-job",
    worker_cores: Optional[int] = None,
    worker_memory_mb: Optional[int] = None,
    max_attempts: int = 3,
    tpu_topology: Optional[str] = None,
    tpu_accelerator: Optional[str] = None,
) -> Dict[str, Any]:
    """Build the indexed-Job manifest dict (pure; used by tests).

    ``tpu_topology``/``tpu_accelerator`` add the GKE TPU nodeSelectors
    (e.g. ``"2x4"`` / ``"tpu-v5-lite-podslice"``) so the Job lands on a
    TPU slice with one worker per host.
    """
    CHECK(len(command) > 0, "kubernetes.build_manifest: empty worker command")
    env_list = [{"name": k, "value": str(v)} for k, v in sorted(envs.items())]
    env_list.append({"name": "DMLC_ROLE", "value": "worker"})
    # downward API: completion index IS the task id
    env_list.append({"name": "DMLC_TASK_ID", "valueFrom": {"fieldRef": {
        "fieldPath": "metadata.annotations['batch.kubernetes.io/job-completion-index']"}}})
    resources: Dict[str, Any] = {}
    if worker_cores:
        resources.setdefault("requests", {})["cpu"] = str(worker_cores)
    if worker_memory_mb:
        resources.setdefault("requests", {})["memory"] = f"{worker_memory_mb}Mi"
    spec: Dict[str, Any] = {
        "template": {
            "spec": {
                "restartPolicy": "OnFailure",
                "containers": [{
                    "name": "worker",
                    "image": image,
                    "command": list(command),
                    "env": env_list,
                    **({"resources": resources} if resources else {}),
                }],
            },
        },
        "completions": nworker,
        "parallelism": nworker,
        "completionMode": "Indexed",
        "backoffLimit": max_attempts * nworker,
    }
    if tpu_topology or tpu_accelerator:
        sel = spec["template"]["spec"].setdefault("nodeSelector", {})
        if tpu_accelerator:
            sel["cloud.google.com/gke-tpu-accelerator"] = tpu_accelerator
        if tpu_topology:
            sel["cloud.google.com/gke-tpu-topology"] = tpu_topology
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": jobname},
        "spec": spec,
    }


def launch(nworker: int, command: List[str], envs: Dict[str, str],
           image: str, kubectl: str = "kubectl", **kw) -> List[int]:
    """Launch ``nworker`` worker Pods running ``command`` with the DMLC env
    ABI injected (TPU-slice nodeSelectors included); builds manifests
    via :func:`build_worker_manifest` and applies them with kubectl."""
    manifest = build_manifest(nworker, command, envs, image, **kw)
    LOG("INFO", "kubernetes launch: job %s × %d", manifest["metadata"]["name"], nworker)
    p = subprocess.run([kubectl, "apply", "-f", "-"],
                       input=json.dumps(manifest), text=True)
    if p.returncode != 0:
        return [p.returncode]
    jobname = manifest["metadata"]["name"]
    return [subprocess.call([kubectl, "wait", "--for=condition=complete",
                             f"job/{jobname}", "--timeout=-1s"])]
