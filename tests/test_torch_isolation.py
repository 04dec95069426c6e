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


def test_kernel_modules_import_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="", CUDA_PATH="")
    res = _run_clean(
        "import dmlc_core_tpu_torch.ops.histogram as h, "
        "dmlc_core_tpu_torch.ops.attention as a, "
        "dmlc_core_tpu_torch.ops._build as b\n"
        "print('OK', h.hist_kernel.launches, h.fused_round_kernel.launches, "
        "a.flash_fwd_kernel.launches)",
        env=env)
    assert res.returncode == 0, res.stderr
    assert "OK 0 0 0" in res.stdout


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
