"""The PyTorch port stands alone: it loads no jax and nothing of the JAX
package, picks the GPU unless told otherwise (and never falls back to the
CPU quietly), and its kernel modules import without a CUDA toolchain."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dmlc_core_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dmlc_core_tpu")

sys.path.insert(0, ROOT)

from dmlc_core_tpu_torch import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.ops import histogram as th  # noqa: E402


def _package_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _run_clean(code, env=None):
    """Run ``code`` in a fresh interpreter (this process has jax loaded:
    tests/conftest.py imports it)."""
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_import_loads_no_jax_module():
    code = (
        "import importlib, sys\n"
        "import dmlc_core_tpu_torch\n"
        "from dmlc_core_tpu_torch import HistGBT\n"
        f"for m in {_package_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", [
    "dmlc_core_tpu_torch.models.bert", "dmlc_core_tpu_torch.ops.attention",
    "dmlc_core_tpu_torch.models.checkpoint"])
def test_bert_path_module_loads_no_jax(module):
    code = (
        "import sys\n"
        f"import {module}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", [
    "dmlc_core_tpu_torch.bench",
    "dmlc_core_tpu_torch.tools.spike_hist_floor",
    "dmlc_core_tpu_torch.tools.serve_threads"])
def test_entry_module_loads_no_jax(module):
    # the port's bench and the one-hot spike are entry points of their
    # own: importing either loads no jax and nothing of the JAX package
    code = (
        "import sys\n"
        f"import {module}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", [
    "dmlc_core_tpu_torch.serve.fleet", "dmlc_core_tpu_torch.serve.tenancy",
    "dmlc_core_tpu_torch.serve.fleet.replica",
    "dmlc_core_tpu_torch.serve.fleet.loadgen",
    "dmlc_core_tpu_torch.launch", "dmlc_core_tpu_torch.tracker",
    "dmlc_core_tpu_torch.base.metrics_agg"])
def test_fleet_tenancy_launch_modules_load_no_jax(module):
    # the rest of the serving tier, the launch tier, the tracker and the
    # metrics spool stand alone too
    code = (
        "import sys\n"
        f"import {module}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", [
    "dmlc_core_tpu_torch.models.resnet",
    "dmlc_core_tpu_torch.data.image_record",
    "dmlc_core_tpu_torch.tools.bench_resnet_feed",
    "dmlc_core_tpu_torch.tools.check_prodsim",
    "dmlc_core_tpu_torch.tools.profile_resnet",
    "dmlc_core_tpu_torch.base.slo", "dmlc_core_tpu_torch.base.lockcheck",
    "dmlc_core_tpu_torch.base.racecheck",
    "dmlc_core_tpu_torch.base.leakcheck",
    "dmlc_core_tpu_torch.utils.profiler"])
def test_resnet_checker_and_drill_modules_load_no_jax(module):
    # the ResNet slice, the checkers and the prodsim drill stand alone
    code = (
        "import sys\n"
        f"import {module}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", [
    "dmlc_core_tpu_torch.serve", "dmlc_core_tpu_torch.models.sklearn",
    "dmlc_core_tpu_torch.models.linear", "dmlc_core_tpu_torch.models.fm",
    "dmlc_core_tpu_torch.parallel.checkpoint"])
def test_serving_and_booster_modules_load_no_jax(module):
    # the serving tier and the other boosters stand alone too
    code = (
        "import sys\n"
        f"import {module}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


#: the examples and their runner, and the chaos drills (ROADMAP item 19)
_ENTRY_GROUPS = {
    "examples": ["dmlc_core_tpu_torch.examples._cli",
                 "dmlc_core_tpu_torch.examples.__main__"]
    + [f"dmlc_core_tpu_torch.examples.{n}" for n in (
        "train_gbt", "rank_pairwise", "sklearn_pipeline",
        "external_memory_gbt", "sparse_highdim_gbt", "fm_libfm",
        "serve_gbt", "stream_gbt", "resnet_recordio", "distributed_local",
        "elastic_recovery")],
    "drills": ["dmlc_core_tpu_torch.tools._drill"]
    + [f"dmlc_core_tpu_torch.tools.check_{n}" for n in (
        "resilience", "elastic", "launch", "fleet", "tenancy", "ps")],
    # the multi-card entry points and the last standalone tools (ROADMAP
    # item 20)
    "multicard_and_tools": ["dmlc_core_tpu_torch.bench"]
    + [f"dmlc_core_tpu_torch.tools.{n}" for n in (
        "check_multichip", "bench_kvstore", "bench_transformer",
        "bench_external", "bench_gblinear", "trace_collect")],
}


@pytest.mark.parametrize("group", sorted(_ENTRY_GROUPS))
def test_example_and_drill_modules_load_no_jax(group):
    # the examples, their runner and the drills stand alone too
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _ENTRY_GROUPS[group])
            + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN!r}\n"
              "             or m.startswith('jax'))\n"
              "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


#: the last host modules (ROADMAP item 18), by group; the native group
#: also builds (where a compiler is found), loads and calls the library
_HOST_GROUPS = {
    "base": ["dmlc_core_tpu_torch.base.common",
             "dmlc_core_tpu_torch.base.config",
             "dmlc_core_tpu_torch.base.thread_local",
             "dmlc_core_tpu_torch.base.wire_schemas",
             "dmlc_core_tpu_torch.utils.memory"],
    "io": ["dmlc_core_tpu_torch.io.json_io",
           "dmlc_core_tpu_torch.io.thread_group",
           "dmlc_core_tpu_torch.io.http_filesys",
           "dmlc_core_tpu_torch.io.s3_filesys",
           "dmlc_core_tpu_torch.io.gcs_filesys",
           "dmlc_core_tpu_torch.io.azure_filesys",
           "dmlc_core_tpu_torch.io.hdfs_filesys"],
    "native": ["dmlc_core_tpu_torch.base._native_build",
               "dmlc_core_tpu_torch.data._native",
               "dmlc_core_tpu_torch.io._native_io",
               "dmlc_core_tpu_torch.io.lockfree"],
    "launchers": ["dmlc_core_tpu_torch.tracker.opts",
                  "dmlc_core_tpu_torch.tracker.launcher",
                  "dmlc_core_tpu_torch.tracker.local",
                  "dmlc_core_tpu_torch.tracker.ssh",
                  "dmlc_core_tpu_torch.tracker.mpi",
                  "dmlc_core_tpu_torch.tracker.slurm",
                  "dmlc_core_tpu_torch.tracker.sge",
                  "dmlc_core_tpu_torch.tracker.yarn",
                  "dmlc_core_tpu_torch.tracker.mesos",
                  "dmlc_core_tpu_torch.tracker.kubernetes",
                  "dmlc_core_tpu_torch.tracker.submit",
                  "dmlc_core_tpu_torch.launch.k8s",
                  "dmlc_core_tpu_torch.launch.config"],
}


@pytest.mark.parametrize("group", sorted(_HOST_GROUPS))
def test_last_host_modules_load_no_jax(group):
    # the native parse and RecordIO library, the remote filesystems, the
    # small base and io modules and the dmlc-submit launchers stand alone
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _HOST_GROUPS[group]))
    if group == "native":
        code += ("from dmlc_core_tpu_torch.data import _native\n"
                 "from dmlc_core_tpu_torch.io import _native_io, lockfree\n"
                 "if _native.native_available():\n"
                 "    _native.parse_libsvm(b'1 0:1.5\\n')\n"
                 "    _native_io.recordio_decode("
                 "_native_io.recordio_encode([b'x']))\n"
                 "    lockfree.Spinlock()\n")
    code += (f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
             "             or m.startswith('jax'))\n"
             "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_base_api_modules_load_no_jax():
    # dmlc-core's parameter, registry and timer API and the knob
    # registry stand alone, used as well as imported
    code = (
        "import sys\n"
        "from dmlc_core_tpu_torch.base import knobs\n"
        "from dmlc_core_tpu_torch.base.parameter import Parameter, field\n"
        "from dmlc_core_tpu_torch.base.registry import (FunctionRegEntry,\n"
        "                                               Registry)\n"
        "from dmlc_core_tpu_torch.base.timer import Timer, "
        "block_until_ready_time\n"
        "class P(Parameter):\n"
        "    k = field(int, default=1, description='k')\n"
        "p = P(k=3)\n"
        "q = P()\n"
        "q.load_json(p.save_json())\n"
        "assert q == p and hash(q) == hash(p) and 'k' in P.doc_string()\n"
        "reg = Registry('isolation_probe')\n"
        "reg.register('f')(lambda: 2)\n"
        "assert isinstance(reg['f'], FunctionRegEntry) and reg['f']() == 2\n"
        "with Timer() as t:\n"
        "    block_until_ready_time(lambda: 1)\n"
        "assert t.elapsed >= 0 and knobs.get('DMLC_INGEST_CHUNK_ROWS')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}\n"
        "             or m.startswith('jax'))\n"
        "print('LOADED', bad)\n")
    res = _run_clean(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_no_finished_kernel_in_source():
    # the port's kernels are its own: no fused attention operator, no
    # torch.compile, no package of finished kernels anywhere in it
    found = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and (
                        node.attr in ("scaled_dot_product_attention",
                                      "cudnn")
                        or node.attr == "compile"
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "torch"):
                    found.append(f"{path}:{node.lineno}: {node.attr}")
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                found += [f"{path}: import {n}" for n in names
                          if n.split(".")[0] in ("flash_attn", "xformers",
                                                 "apex", "transformer_engine")]
    assert found == []


def test_no_forbidden_import_in_source():
    found = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for name in names:
                    root = name.split(".")[0]
                    if root in FORBIDDEN or root.startswith("jax"):
                        found.append(f"{path}: {name}")
    assert found == []


def test_default_device_needs_a_gpu(monkeypatch):
    # whatever the host has, a missing GPU must raise, not run on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="no CUDA GPU"):
        HistGBT()
    with pytest.raises(Error, match="no CUDA GPU"):
        HistGBT(device="cuda")
    assert HistGBT(device="cpu").device.type == "cpu"
    from dmlc_core_tpu_torch.models import ResNetTrainer

    with pytest.raises(Error, match="no CUDA GPU"):
        ResNetTrainer(variant="resnet-micro")


def test_kernel_modules_import_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="", CUDA_PATH="")
    res = _run_clean(
        "import dmlc_core_tpu_torch.ops.histogram as h, "
        "dmlc_core_tpu_torch.ops.attention as a, "
        "dmlc_core_tpu_torch.tools.spike_hist_floor as s, "
        "dmlc_core_tpu_torch.ops._build as b\n"
        "print('OK', h.hist_kernel.launches, h.fused_round_kernel.launches, "
        "a.flash_fwd_kernel.launches, sum(s.kernel_variant.launches.values()))",
        env=env)
    assert res.returncode == 0, res.stderr
    assert "OK 0 0 0 0" in res.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    # no path from a kernel wrapper to the plain version: a CPU tensor is
    # an error there, and only the public dispatch runs the plain version
    n, F, B = 64, 3, 8
    bins = torch.zeros(F, n, dtype=torch.uint8)
    node = torch.zeros(n, dtype=torch.int32)
    g = torch.ones(n)
    with pytest.raises(Error, match="CUDA"):
        th.hist_kernel(bins, node, g, g, 1, B, 0, 0)
    prev = torch.zeros(2, 1, F, B)
    with pytest.raises(Error, match="CUDA"):
        th.fused_round_kernel(bins, node, node[:1], node[:1], g, g, prev, 1,
                              B, 0, 0, True)
    assert th.hist_kernel.launches == 0
    hist = th.build_histogram(bins, node, g, g, 1, B)
    np.testing.assert_array_equal(hist[0, 0, :, 0].numpy(), np.full(F, n))
