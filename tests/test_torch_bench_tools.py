"""The port's standalone tools beside the JAX scripts they port, on the CPU
at cut sizes: ``tools/bench_kvstore.py`` (2 gloo ranks),
``tools/bench_transformer.py`` (``--smoke``), ``tools/bench_external.py``
and ``tools/bench_gblinear.py`` (20,000 rows of the generator's text),
``tools/trace_collect.py`` (hand-built shards).

Each prints the JAX script's JSON fields (the JAX script run as a
subprocess on the same knobs; for ``bench_transformer``, whose JAX script
has no cut size, the keys of its records read from its source), and every
tool but ``trace_collect`` (host code) refuses to run without a GPU
unless ``--device cpu`` is given.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import trace_collect as jax_trace_collect  # noqa: E402
from dmlc_core_tpu_torch.tools import trace_collect  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "DMLC_"))}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(cmd, env, timeout=300):
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return [json.loads(ln) for ln in res.stdout.splitlines()
            if ln.startswith("{")]


def _port(tool, env, *args):
    return _run([sys.executable, "-m", f"dmlc_core_tpu_torch.tools.{tool}",
                 *args], env)


def _jax(script, env):
    return _run([sys.executable, os.path.join(ROOT, "scripts", script)], env)


def test_bench_kvstore_on_two_gloo_ranks():
    env = _env(BENCH_KV_DEVICES=2)
    port = _port("bench_kvstore", env, "--device", "cpu")
    want = _jax("bench_kvstore.py", env)
    assert [r["mode"] for r in port] == [r["mode"] for r in want] == \
        ["per-key", "bucketed"]
    for p, w in zip(port, want):
        assert set(w) <= set(p), set(w) - set(p)
        for k in ("keys", "params", "workers", "collectives_per_step",
                  "grad_mb_per_step", "allreduce_bus_mb_per_step",
                  "platform"):
            assert p[k] == w[k], (p["mode"], k)
        assert p["bus_gbps"] > 0 and p["steps_per_sec"] > 0
    assert port[0]["keys"] == 199
    assert port[0]["collectives_per_step"] == 199
    assert port[1]["collectives_per_step"] == 1


def _jax_transformer_keys():
    """The keys of each record ``scripts/bench_transformer.py`` returns
    (its shapes are fixed at BERT-base width, too large for a CPU test)."""
    src = open(os.path.join(ROOT, "scripts", "bench_transformer.py")).read()
    keys = {}
    for fn in ast.parse(src).body:
        if isinstance(fn, ast.FunctionDef) and fn.name.startswith("bench_"):
            ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][0]
            keys[fn.name[len("bench_"):]] = {
                k.value for k in ret.value.keys if k is not None}
    return keys


def test_bench_transformer_smoke_prints_jaxs_fields():
    lines = _port("bench_transformer", _env(BENCH_T_STEPS=2, BENCH_T_CHUNK=1),
                  "--device", "cpu", "--smoke")
    want = _jax_transformer_keys()
    assert set(want) == {"bert", "moe", "pipeline"}
    assert [r["model"] for r in lines] == ["bert_base", "switch_moe",
                                           "pipeline_lm"]
    for rec, name in zip(lines, ("bert", "moe", "pipeline")):
        assert "error" not in rec, rec
        # the JAX records' keys, its memory fields and platform among them
        assert want[name] | {"hbm_peak_mb", "hbm_in_use_mb",
                             "platform"} <= set(rec), name
        assert rec["steps"] == 2 and len(rec["chunk_times"]) == 2
        assert rec["final_loss"] == rec["final_loss"]      # finite
        assert rec["platform"] == "cpu" and rec["hbm_peak_mb"] is None
    # the CPU takes the dense oracle: no kernel launches
    assert lines[0]["flash_launches"] == {"flash_fwd": 0,
                                          "flash_bwd_dkv": 0,
                                          "flash_bwd_dq": 0}


def test_bench_external_at_a_cut_size(tmp_path):
    env = _env(BENCH_EXT_DIR=tmp_path, BENCH_EXT_ROWS=20000,
               BENCH_EXT_ROUNDS=4)
    (port,) = _port("bench_external", env, "--device", "cpu")
    # the JAX script finds the text the port's generator wrote (it would
    # run a prebuilt build/gen_libsvm otherwise)
    (want,) = _jax("bench_external.py", env)
    assert set(want) <= set(port), set(want) - set(port)
    for k in ("rows", "features", "depth", "bins", "text_gb", "pages",
              "pageloop_rounds", "platform"):
        assert port[k] == want[k], k
    assert port["gen_seconds"] >= 0
    assert port["cache_device_route"] == "cached"
    assert port["cache_device_rounds_per_sec"] > 0


def test_bench_gblinear_at_a_cut_size(tmp_path):
    env = _env(BENCH_EXT_DIR=tmp_path, BENCH_GBLIN_ROWS=20000,
               BENCH_GBLIN_ROUNDS=4)
    (port,) = _port("bench_gblinear", env, "--device", "cpu")
    (want,) = _jax("bench_gblinear.py", env)
    assert set(want) <= set(port), set(want) - set(port)
    for k in ("rows", "features", "rounds", "feature_dtype",
              "matrix_gb_on_device"):
        assert port[k] == want[k], k
    # the same rows, bf16 features and rounds: the same model
    assert port["weight_norm"] == pytest.approx(want["weight_norm"],
                                                abs=2e-4)
    assert port["bias"] == pytest.approx(want["bias"], abs=2e-5)


@pytest.mark.parametrize("tool", ["bench_kvstore", "bench_transformer",
                                  "bench_external", "bench_gblinear",
                                  "check_multichip"])
def test_tools_need_a_gpu_unless_asked_for_the_cpu(tool, tmp_path):
    env = _env(CUDA_VISIBLE_DEVICES="", BENCH_EXT_DIR=tmp_path)
    res = subprocess.run([sys.executable, "-m",
                          f"dmlc_core_tpu_torch.tools.{tool}"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "no CUDA GPU" in res.stderr, res.stderr[-2000:]
    assert list(tmp_path.iterdir()) == []        # nothing generated


def _shard(path, pid, role, epoch, events, dropped=0):
    path.write_text(json.dumps({
        "traceEvents": [{"ph": "M", "name": "process_name", "pid": pid,
                         "args": {"name": role}}] + events,
        "otherData": {"pid": pid, "role": role, "epoch_us": epoch,
                      "dropped_events": dropped}}))


def test_trace_collect_is_jaxs_merge_and_cli(tmp_path):
    spool = tmp_path / "spool"
    spool.mkdir()
    tid = "cd" * 16
    _shard(spool / "trace-router-0-11.json", 11, "router", 1_000_000.0,
           [{"name": "fleet.route", "ph": "X", "ts": 10.0, "dur": 5.0,
             "pid": 11, "tid": 1, "args": {"trace": tid}}], dropped=2)
    _shard(spool / "trace-replica-1-22.json", 22, "replica", 1_500_000.0,
           [{"name": "http./predict", "ph": "X", "ts": 3.0, "dur": 1.0,
             "pid": 22, "tid": 1, "args": {"trace": tid}},
            {"name": "idle", "ph": "i", "ts": 4.0, "pid": 22, "tid": 1}])
    (spool / "trace-torn-0-3.json").write_text("{torn")
    assert trace_collect.collect(str(spool)) == \
        jax_trace_collect.collect(str(spool))
    out = tmp_path / "merged.json"
    res = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.trace_collect",
         str(spool), "-o", str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout)
    assert summary["processes"] == 2 and summary["dropped_events"] == 2
    assert summary["traces"][tid]["pids"] == [11, 22]
    assert json.loads(out.read_text()) == \
        jax_trace_collect.collect(str(spool))[0]
    empty = tmp_path / "empty"
    empty.mkdir()
    res = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.trace_collect",
         str(empty)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
