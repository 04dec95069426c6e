"""Central registry of every wire-visible key in the control plane.

The repo's distributed layers speak three JSON dialects: the Rabit
tracker line protocol (``tracker/tracker.py``), the elastic
membership/collective protocol (``parallel/recovery.py``), and the
parameter-server header+arrays framing (``parallel/ps/wire.py``) —
plus the ``DMLC_*`` env ABI the launchers inject into workers.  A key
that one side sends and the other side never reads is protocol drift:
it hangs a worker or silently drops a field instead of failing a test.

This module is that contract, written down once.  The ``wire-schema``
dmlcheck pass (``analysis/protocol.py``) parses this file *statically*
(so lint fixtures can ship their own copy) and flags any literal
message dict whose ``"cmd"`` is undeclared or whose keys stray outside
the declared set.  Adding a field to a message therefore starts here;
the lint failure on the sending site is the reminder to update the
receiving side in the same change.

``WIRE_FRAMING`` keys are added by the transport itself
(:func:`dmlc_core_tpu_torch.parallel.ps.wire.send_msg` appends the
``"arrays"`` descriptor list) and are allowed on every command.
"""

from __future__ import annotations

from typing import Dict, FrozenSet

__all__ = ["COMMANDS", "ENV_ABI", "WIRE_FRAMING", "allowed_keys"]

#: ``cmd`` value → full set of keys the sender may put in the header.
#: Kept as literal frozensets so the lint pass can read them without
#: importing the package under analysis.
COMMANDS: Dict[str, FrozenSet[str]] = {
    # -- Rabit tracker line protocol (tracker/tracker.py) ---------------
    "start": frozenset({"cmd", "host", "rank", "persistent"}),
    "recover": frozenset({"cmd", "host", "rank", "persistent"}),
    "print": frozenset({"cmd", "msg"}),
    "shutdown": frozenset({"cmd"}),
    "commit": frozenset({"cmd", "rank", "round"}),
    # -- elastic membership + collectives (parallel/recovery.py) --------
    "join": frozenset({"cmd", "rank", "timeout_s"}),
    "abort": frozenset({"cmd", "epoch", "rank", "reason"}),
    "coll": frozenset({"cmd", "op", "rank", "epoch", "seq", "root",
                       "payload"}),
    # -- fleet endpoint registry (serve/fleet/replica.py) ---------------
    "serve_register": frozenset({"cmd", "rank", "url"}),
    "serve_report": frozenset({"cmd", "rank", "load", "tenants"}),
    # -- parameter-server wire (parallel/ps/) ---------------------------
    "ps_register": frozenset({"cmd", "host", "port", "server_id"}),
    "ps_servers": frozenset({"cmd"}),
    "init": frozenset({"cmd", "name", "n_keys", "width", "dtype", "lr",
                       "init_scale", "seed"}),
    "push": frozenset({"cmd", "name", "rank", "clock"}),
    "pull": frozenset({"cmd", "name", "rank", "clock", "staleness",
                       "timeout_s"}),
    "clock": frozenset({"cmd", "rank", "clock"}),
    "pull_range": frozenset({"cmd", "name"}),
    "bye": frozenset({"cmd", "rank"}),
}

#: Keys the wire layer itself attaches to every header; always allowed.
#: ``trace`` is the distributed trace context (base/tracectx) the
#: transport stamps on outbound headers when tracing is enabled.
WIRE_FRAMING: FrozenSet[str] = frozenset({"arrays", "trace"})

#: The launch env ABI: every ``DMLC_*`` variable a launcher/tracker may
#: *inject* into a worker's environment.  Knob names declared in
#: ``base/knobs.py`` ride the env too and are implicitly allowed.
ENV_ABI: FrozenSet[str] = frozenset({
    "DMLC_TASK_ID",
    "DMLC_ROLE",
    "DMLC_NUM_ATTEMPT",
    "DMLC_NUM_WORKER",
    "DMLC_NUM_SERVER",
    "DMLC_TRACKER_URI",
    "DMLC_TRACKER_PORT",
    "DMLC_LEGACY_TRACKER_PORT",
    "DMLC_PS_ROOT_URI",
    "DMLC_PS_ROOT_PORT",
    "DMLC_WORKDIR",
    "DMLC_METRICS_SPOOL",
    "DMLC_TRACE_CTX",
})


def allowed_keys(cmd: str) -> FrozenSet[str]:
    """Full allowed header key set for ``cmd`` (declared ∪ framing);
    raises ``KeyError`` for an undeclared command."""
    return COMMANDS[cmd] | WIRE_FRAMING
