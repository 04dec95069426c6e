"""The port's knob registry (``dmlc_core_tpu_torch/base/knobs.py``)
against the port's sources and the JAX package's registry, on the CPU.

Every ``DMLC_*`` name that appears as a string literal in the port's
code (the rule of the JAX package's ``knob-registry`` pass: an AST string
constant that is the whole name) is declared, and every declaration is
read somewhere.  Where both packages declare a name, the default and the
group are the JAX package's; the doc may say how the port's meaning
differs.  The registry's API is JAX's.  ``DMLC_SLO_SPEC`` scores the port
bench's final records.
"""

import ast
import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dmlc_core_tpu.base import knobs as jax_knobs  # noqa: E402
from dmlc_core_tpu_torch import bench as port_bench  # noqa: E402
from dmlc_core_tpu_torch.base import knobs  # noqa: E402

PKG = os.path.join(ROOT, "dmlc_core_tpu_torch")
_KNOB_RE = re.compile(r"^DMLC_[A-Z0-9_]+$")


def _literals():
    """``{name: first file}`` of every whole-name ``DMLC_*`` string
    constant in the port's code, its registry left out."""
    found = {}
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or path == knobs.__file__:
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and _KNOB_RE.match(node.value)):
                    found.setdefault(node.value,
                                     os.path.relpath(path, ROOT))
    return found


def test_every_knob_the_port_reads_is_declared():
    used = _literals()
    assert len(used) > 90
    missing = {k: f for k, f in used.items() if knobs.get(k) is None}
    assert not missing, missing
    # and no declaration is stale
    assert sorted(set(knobs.names()) - set(used)) == []


def test_shared_knobs_keep_the_jax_defaults_and_groups():
    shared = sorted(set(knobs.names()) & set(jax_knobs.names()))
    assert len(shared) == len(knobs.names()) - 1     # DMLC_LAUNCH_SPOOL
    for name in shared:
        mine, theirs = knobs.get(name), jax_knobs.get(name)
        assert mine.default == theirs.default, name
        assert type(mine.default) is type(theirs.default), name
        assert mine.group == theirs.group, name
        assert mine.doc, name


def test_the_slice_knobs_are_declared_as_jax_declares_them():
    for name in ("DMLC_COLDSTART_OVERLAP", "DMLC_WARMUP_EXEC",
                 "DMLC_INGEST_CHUNK_ROWS", "DMLC_METRICS_GBT_PHASES",
                 "DMLC_SLO_SPEC"):
        assert knobs.get(name).default == jax_knobs.get(name).default


def test_registry_api_is_jaxs(monkeypatch):
    assert knobs.names() == sorted(knobs.names())
    ordered = knobs.all_knobs()
    assert [(k.group, k.name) for k in ordered] == sorted(
        (k.group, k.name) for k in ordered)
    assert knobs.get("DMLC_NOT_A_KNOB") is None
    k = knobs.get("DMLC_INGEST_CHUNK_ROWS")
    assert knobs.declare(k.name, k.default, k.doc, k.group) == k
    with pytest.raises(ValueError, match="re-declared"):
        knobs.declare(k.name, 1, k.doc, k.group)
    with pytest.raises(ValueError, match="DMLC_"):
        knobs.declare("NOT_DMLC", 0, "x")
    monkeypatch.setenv("DMLC_INGEST_CHUNK_ROWS", "96")
    assert knobs.value("DMLC_INGEST_CHUNK_ROWS") == 96
    monkeypatch.delenv("DMLC_INGEST_CHUNK_ROWS")
    assert knobs.value("DMLC_INGEST_CHUNK_ROWS") == 2_000_000
    with pytest.raises(KeyError):
        knobs.value("DMLC_NOT_A_KNOB")


def test_slo_spec_scores_a_final_record(monkeypatch, tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "t", "objectives": [
        {"name": "fast", "op": ">=", "threshold": 1.0,
         "source": {"evidence": "value"}}]}))
    monkeypatch.setenv("DMLC_SLO_SPEC", str(spec))
    rec = {"value": 2.5}
    port_bench._attach_metrics(rec)
    assert rec["slo"]["spec"] == "t" and rec["slo"]["pass"] is True
    assert rec["slo"]["objectives"][0]["observed"] == 2.5
    rec = {"value": 0.5}
    port_bench._attach_slo(rec)
    assert rec["slo"]["pass"] is False
    monkeypatch.setattr(sys, "argv", ["bench", "--slo", str(tmp_path / "x")])
    rec = {"value": 2.5}
    port_bench._attach_slo(rec)                  # --slo wins; never fatal
    assert "slo" not in rec and "slo_error" in rec
    monkeypatch.delenv("DMLC_SLO_SPEC")
    monkeypatch.setattr(sys, "argv", ["bench"])
    rec = {"value": 2.5}
    port_bench._attach_slo(rec)
    assert "slo" not in rec and "slo_error" not in rec
