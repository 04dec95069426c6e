"""A checkpoint save killed at any step leaves a loadable version (ROADMAP
C19).

A local save with retention moves the current version's pair — its body
and its CRC sidecar — to ``.prev``, then writes the new body and the new
sidecar, each by an atomic rename.  A process killed between two of
those renames must leave either the old or the new version loadable.

The JAX package moves the body first: killed between the two moves, it
leaves no primary and a ``.prev`` body beside the older version's
sidecar, so the load finds no valid version.  The prodsim drill's PS
server, snapshotting every tick, is SIGKILLed at a wall-clock time; on a
loaded host the two moves lie far enough apart for the kill to land
between them now and then, and the respawned server could not restore.
The port moves the sidecar first.  The test kills a save (an exception
raised in place of a rename) before each rename in turn.
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dmlc_core_tpu.base.logging import Error as JaxError  # noqa: E402
from dmlc_core_tpu.parallel import checkpoint as jax_ckpt  # noqa: E402
from dmlc_core_tpu_torch.parallel import checkpoint as port_ckpt  # noqa: E402


class _Killed(BaseException):
    """Stands for a SIGKILL: nothing after it runs."""


def _state(version):
    rng = np.random.default_rng(version)
    return {"w": rng.standard_normal(64).astype(np.float32),
            "round": np.int64(version)}


def _save_killed(mod, monkeypatch, uri, version, before):
    """Save ``version``, killed before its rename number ``before``
    (counting from 0; past the last rename: a whole save)."""
    real = os.replace
    seen = {"n": 0}

    def replace(src, dst):
        if seen["n"] == before:
            raise _Killed
        seen["n"] += 1
        return real(src, dst)

    with monkeypatch.context() as m:
        m.setattr(os, "replace", replace)
        try:
            mod.checkpoint(uri, _state(version), version=version, local=True)
        except _Killed:
            return False
    return True


@pytest.mark.parametrize("before", range(5))
def test_a_save_killed_at_any_rename_leaves_a_version(before, tmp_path,
                                                      monkeypatch):
    uri = str(tmp_path / "ck")
    for v in (1, 2):
        port_ckpt.checkpoint(uri, _state(v), version=v, local=True)
    whole = _save_killed(port_ckpt, monkeypatch, uri, 3, before)
    assert whole == (before == 4)
    version, state = port_ckpt.load_checkpoint(uri, _state(0))
    assert version in (2, 3)
    np.testing.assert_array_equal(state["w"], _state(version)["w"])
    assert int(np.asarray(state["round"]).ravel()[0]) == version
    if whole:
        assert version == 3
    # the next whole save is loadable, and so is its fallback
    port_ckpt.checkpoint(uri, _state(4), version=4, local=True)
    assert port_ckpt.load_checkpoint(uri, _state(0))[0] == 4
    os.unlink(uri)
    assert port_ckpt.load_checkpoint(uri, _state(0))[0] in (2, 3)


def test_the_reference_loses_every_version_between_the_two_moves(
        tmp_path, monkeypatch):
    # the divergence: killed after moving the body and before moving its
    # sidecar, the JAX package's save leaves nothing it can load
    uri = str(tmp_path / "ck")
    for v in (1, 2):
        jax_ckpt.checkpoint(uri, _state(v), version=v, local=True)
    assert not _save_killed(jax_ckpt, monkeypatch, uri, 3, 1)
    assert not os.path.exists(uri)
    with pytest.raises(JaxError, match="no valid version"):
        jax_ckpt.load_checkpoint(uri, _state(0))
    # the port's save, killed at the same rename, keeps version 2
    uri = str(tmp_path / "port")
    for v in (1, 2):
        port_ckpt.checkpoint(uri, _state(v), version=v, local=True)
    assert not _save_killed(port_ckpt, monkeypatch, uri, 3, 1)
    assert port_ckpt.load_checkpoint(uri, _state(0))[0] == 2


def test_a_save_without_retention_drops_the_stale_sidecar_first(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_CKPT_KEEP", "0")
    uri = str(tmp_path / "ck")
    port_ckpt.checkpoint(uri, _state(1), version=1, local=True)
    # killed after the new body's rename, before its sidecar's
    assert not _save_killed(port_ckpt, monkeypatch, uri, 2, 1)
    version, state = port_ckpt.load_checkpoint(uri, _state(0))
    assert version == 2
    np.testing.assert_array_equal(state["w"], _state(2)["w"])
