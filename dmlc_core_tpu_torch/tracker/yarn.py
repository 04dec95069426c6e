"""YARN launch backend with elastic per-worker restart.

Reference parity: ``tracker/dmlc_tracker/yarn.py`` + ``tracker/yarn/``
Java client (SURVEY.md §2c).  The reference ships a Java ApplicationMaster
that negotiates containers and **restarts failed ones up to a max-attempt
count, exporting ``DMLC_NUM_ATTEMPT``** — its only elastic piece.  This
build reproduces that semantics in Python instead of Java:

- :func:`build_command` constructs a distributed-shell submission (the
  non-elastic bulk path, one app with N containers), and
- :class:`ElasticYarnJob` plays the ApplicationMaster role — one YARN app
  per worker, health observed through the ResourceManager **REST API**
  (``/ws/v1/cluster/apps/{id}``, the supported remote surface; the Java AM
  used the in-cluster AM-RM protocol, unavailable off-cluster), failed
  workers resubmitted with ``DMLC_NUM_ATTEMPT`` incremented until
  ``max_attempts`` is exhausted.

No JVM is required on the client beyond the ``hadoop`` CLI itself.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from dmlc_core_tpu_torch.base.logging import CHECK, LOG, Error

__all__ = ["build_command", "launch", "launch_elastic", "YarnRestClient",
           "ElasticYarnJob"]


def build_command(
    nworker: int,
    command: List[str],
    envs: Dict[str, str],
    queue: Optional[str] = None,
    jobname: str = "dmlc-job",
    worker_cores: int = 1,
    worker_memory_mb: int = 1024,
    hadoop_binary: str = "hadoop",
    app_jar: Optional[str] = None,
) -> List[str]:
    """Construct the YARN distributed-shell submission (pure; for tests).

    ``app_jar`` defaults to ``$HADOOP_HOME``'s distributed-shell jar; the
    worker command runs once per container with the env ABI exported.
    """
    CHECK(len(command) > 0, "yarn.build_command: empty worker command")
    jar = app_jar or os.path.join(
        os.environ.get("HADOOP_HOME", "/opt/hadoop"),
        "share/hadoop/yarn/hadoop-yarn-applications-distributedshell.jar")
    cmd = [
        hadoop_binary, "jar", jar,
        "-jar", jar,
        "-appname", jobname,
        "-num_containers", str(nworker),
        "-container_vcores", str(worker_cores),
        "-container_memory", str(worker_memory_mb),
        "-shell_command", " ".join(command),
    ]
    if queue:
        cmd += ["-queue", queue]
    env = dict(envs)
    env.setdefault("DMLC_ROLE", "worker")
    for k, v in sorted(env.items()):
        cmd += ["-shell_env", f"{k}={v}"]
    return cmd


def launch(nworker: int, command: List[str], envs: Dict[str, str],
           **kw) -> List[int]:
    """Launch workers as YARN containers through the elastic Python AM
    loop (reference dmlc_tracker/yarn.py + Java AM role)."""
    cmd = build_command(nworker, command, envs, **kw)
    LOG("INFO", "yarn launch: %s", " ".join(cmd))
    return [subprocess.call(cmd, env=dict(os.environ))]


# ---------------------------------------------------------------------------
# Elastic restart (the reference Java AM's semantics, in Python)
# ---------------------------------------------------------------------------

class YarnRestClient:
    """Minimal ResourceManager REST API client (read-only).

    Speaks the stable ``/ws/v1/cluster/apps/{app_id}`` endpoint; returns
    the ``(state, finalStatus)`` pair YARN reports, e.g. ``("RUNNING",
    "UNDEFINED")`` or ``("FINISHED", "FAILED")``.
    """

    def __init__(self, rm_uri: str, timeout: float = 10.0):
        self.rm_uri = rm_uri.rstrip("/")
        self.timeout = timeout

    def app_status(self, app_id: str) -> Tuple[str, str]:
        url = f"{self.rm_uri}/ws/v1/cluster/apps/{app_id}"
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            doc = json.loads(resp.read().decode())
        app = doc.get("app", {})
        return app.get("state", "UNKNOWN"), app.get("finalStatus", "UNDEFINED")

    def kill_app(self, app_id: str) -> None:
        """Best-effort kill via ``PUT /apps/{id}/state`` (RM REST API)."""
        url = f"{self.rm_uri}/ws/v1/cluster/apps/{app_id}/state"
        req = urllib.request.Request(
            url, data=json.dumps({"state": "KILLED"}).encode(),
            headers={"Content-Type": "application/json"}, method="PUT")
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except OSError:
            LOG("WARNING", "yarn: failed to kill app %s", app_id)


class ElasticYarnJob:
    """Application-master loop: launch N workers, restart the failed ones.

    Reference parity: ``tracker/yarn/src/.../ApplicationMaster.java`` —
    on container failure it re-requested a container and relaunched the
    task with ``DMLC_NUM_ATTEMPT`` incremented, aborting the job once any
    task exceeded the maximum attempt count.  Here each worker is its own
    YARN application (1-container distributed-shell) observed via the RM
    REST API, so the same per-task restart policy works from off-cluster.

    ``submit_fn(task_id, envs) -> app_id`` performs one worker submission;
    the default shells out ``hadoop jar ...`` per worker (``num_containers
    = 1``) and parses the application id from the client output.  Tests
    inject a fake ``submit_fn`` + fake RM server.
    """

    #: terminal YARN app states
    _TERMINAL = frozenset({"FINISHED", "FAILED", "KILLED"})

    def __init__(
        self,
        nworker: int,
        envs: Dict[str, str],
        submit_fn: Callable[[int, Dict[str, str]], str],
        rest: YarnRestClient,
        max_attempts: int = 3,
        poll_interval: float = 1.0,
    ):
        CHECK(nworker >= 1, "ElasticYarnJob: need at least one worker")
        CHECK(max_attempts >= 1, "ElasticYarnJob: max_attempts must be >= 1")
        self.nworker = nworker
        self.envs = dict(envs)
        self.submit_fn = submit_fn
        self.rest = rest
        self.max_attempts = max_attempts
        self.poll_interval = poll_interval
        self.attempts: Dict[int, int] = {}       # task_id -> attempts used
        self.app_of: Dict[int, str] = {}         # task_id -> current app id
        self.restarts: List[Dict[str, Any]] = [] # audit log of resubmissions

    def _submit(self, task_id: int) -> None:
        attempt = self.attempts.get(task_id, 0)
        env = dict(self.envs)
        env["DMLC_TASK_ID"] = str(task_id)
        env["DMLC_NUM_ATTEMPT"] = str(attempt)
        env["DMLC_ROLE"] = env.get("DMLC_ROLE", "worker")
        self.app_of[task_id] = self.submit_fn(task_id, env)
        self.attempts[task_id] = attempt + 1

    #: consecutive RM poll failures tolerated before giving up on the job
    max_poll_errors: int = 10

    def run(self, job_timeout: Optional[float] = None) -> Dict[int, int]:
        """Launch all workers and babysit until every task SUCCEEDED.

        Returns ``{task_id: attempts_used}``.  Raises :class:`Error` when a
        task fails ``max_attempts`` times or the timeout expires; on any
        abort the still-pending apps are killed (the Java AM likewise tore
        down remaining containers), so nothing is left orphaned on the
        cluster.  Transient RM REST failures are retried up to
        ``max_poll_errors`` consecutive rounds before counting as fatal.
        """
        deadline = None if job_timeout is None else time.monotonic() + job_timeout
        pending = set()
        try:
            for t in range(self.nworker):
                self._submit(t)
                pending.add(t)
            poll_errors = 0
            while pending:
                if deadline is not None and time.monotonic() > deadline:
                    raise Error(f"yarn job timed out with tasks "
                                f"{sorted(pending)} pending")
                for t in sorted(pending):
                    try:
                        state, final = self.rest.app_status(self.app_of[t])
                        poll_errors = 0
                    except OSError as e:
                        poll_errors += 1
                        LOG("WARNING", "yarn: RM poll failed (%d/%d): %s",
                            poll_errors, self.max_poll_errors, e)
                        if poll_errors >= self.max_poll_errors:
                            raise Error(f"yarn: ResourceManager unreachable "
                                        f"after {poll_errors} consecutive "
                                        f"poll failures: {e}")
                        break  # back off this round, retry next poll
                    if state not in self._TERMINAL:
                        continue
                    if final == "SUCCEEDED":
                        pending.discard(t)
                        continue
                    # container/app failed — the Java AM's restart branch
                    if self.attempts[t] >= self.max_attempts:
                        raise Error(
                            f"yarn task {t} failed {self.attempts[t]} times "
                            f"(max_attempts={self.max_attempts}); aborting job")
                    LOG("WARNING", "yarn task %d app %s %s/%s — resubmitting "
                        "(attempt %d/%d)", t, self.app_of[t], state, final,
                        self.attempts[t], self.max_attempts)
                    self.restarts.append({"task": t, "app": self.app_of[t],
                                          "final": final,
                                          "attempt": self.attempts[t]})
                    self._submit(t)
                if pending:
                    time.sleep(self.poll_interval)
        except BaseException:
            for t in sorted(pending):
                self.rest.kill_app(self.app_of[t])
            raise
        return dict(self.attempts)


def _hadoop_submit_fn(command: List[str], submit_timeout: float = 120.0,
                      **kw) -> Callable[[int, Dict[str, str]], str]:
    """Production submit_fn: one 1-container app per worker via hadoop CLI.

    The distributed-shell client *monitors* its app until completion, so we
    must NOT wait for the process — a reader thread watches its combined
    stdout+stderr (hadoop logs via log4j to stderr by default) just long
    enough to see the ``Submitted application application_...`` line, then
    keeps DRAINING the pipe in the background (a client that outlives the
    parse would otherwise fill the OS pipe buffer and deadlock) and reaps
    the process when it exits.  The deadline applies to the submission as
    a whole, so a silent client (unreachable ResourceManager, Kerberos
    stall) raises instead of blocking forever in readline.
    """
    def submit(task_id: int, env: Dict[str, str]) -> str:
        cmd = build_command(1, command, env,
                            jobname=f"{kw.get('jobname', 'dmlc-job')}-t{task_id}",
                            **{k: v for k, v in kw.items() if k != "jobname"})
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=dict(os.environ))
        assert proc.stdout is not None
        found: queue.Queue = queue.Queue()
        seen: List[str] = []

        def reader() -> None:
            app_reported = False
            for line in proc.stdout:
                if not app_reported:
                    seen.append(line)
                    for tok in line.split():
                        if tok.startswith("application_"):
                            found.put(tok.strip(",;"))
                            app_reported = True
                            break
                # else: keep draining so the monitor never blocks on a
                # full pipe
            rc = proc.wait()  # reap; no zombie per submission
            if not app_reported:
                found.put(Error(
                    f"yarn submission for task {task_id} exited rc={rc} "
                    f"without an application id; output tail: "
                    f"{''.join(seen[-20:])!r}"))

        threading.Thread(target=reader, daemon=True,
                         name=f"yarn-submit-{task_id}").start()
        try:
            result = found.get(timeout=submit_timeout)
        except queue.Empty:
            proc.kill()
            raise Error(f"yarn submission for task {task_id} produced no "
                        f"application id within {submit_timeout}s")
        if isinstance(result, Error):
            raise result
        return result
    return submit


def launch_elastic(nworker: int, command: List[str], envs: Dict[str, str],
                   rm_uri: str, max_attempts: int = 3,
                   poll_interval: float = 5.0, **kw) -> Dict[int, int]:
    """Launch with per-worker restart (the reference AM behavior)."""
    job = ElasticYarnJob(nworker, envs, _hadoop_submit_fn(command, **kw),
                         YarnRestClient(rm_uri), max_attempts=max_attempts,
                         poll_interval=poll_interval)
    return job.run()
