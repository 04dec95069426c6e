"""Distributed job launch & coordination (L7).

Reference parity: ``tracker/dmlc_tracker/`` — the ``dmlc-submit`` CLI,
cluster backends, the RabitTracker coordination service and the ``DMLC_*``
env-var ABI (SURVEY.md §2c).

Torch workers coordinate through ``torch.distributed`` (rank 0 hosts
its TCP store; ``collectives.init`` maps ``DMLC_TRACKER_URI:PORT``
onto it), so the tracker here is a :class:`RabitTracker` service kept
for rabit-protocol workers, for the serving fleet's control plane
(``serve/fleet/replica.py``) and as the tested home of the tree/ring
topology math.

The launcher backends (``local``, ``ssh``, ``mpi``, ``slurm``, ``sge``,
``yarn``, ``mesos``, ``kubernetes``) sit under the ``dmlc-submit`` CLI,
``python -m dmlc_core_tpu_torch.tracker.submit`` (``submit``, ``opts``);
``launcher`` is the per-worker shim that fills the env ABI.
"""

from dmlc_core_tpu_torch.tracker.tracker import RabitTracker, PSTracker, submit  # noqa: F401
