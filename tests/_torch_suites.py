"""The JAX package's own test files, loaded against the port.

:func:`load_port` reads ``tests/<fname>``, replaces every
``dmlc_core_tpu`` module name by its ``dmlc_core_tpu_torch`` counterpart
(plus the file's own substitutions) and executes it as a module;
:func:`export` puts the chosen classes and functions into a test module's
namespace with a ``_port`` suffix, the left-out tests of a class set to
``None`` so that pytest does not collect them.

The port's entry points run on ``cuda`` unless told otherwise; the JAX
files construct models without a device.  :func:`on_cpu` (an autouse
fixture in each file that loads a suite) makes ``device=None`` mean the
CPU for the test's duration, in every module of the port that resolves
a device — the caller asking for the CPU, as every port test does.
"""

import os
import re
import sys
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

# every port module that resolves a device, imported before on_cpu looks
import dmlc_core_tpu_torch.data.device_feed  # noqa: E402,F401
import dmlc_core_tpu_torch.models  # noqa: E402,F401
import dmlc_core_tpu_torch.models.sklearn  # noqa: E402,F401
import dmlc_core_tpu_torch.serve  # noqa: E402,F401
import dmlc_core_tpu_torch.serve.fleet  # noqa: E402,F401
from dmlc_core_tpu_torch.utils import device as _device  # noqa: E402


def load_port(fname, subs=()):
    """``tests/<fname>`` as a module against the port."""
    src = open(os.path.join(TESTS, fname)).read()
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    src = re.sub(r"\bdmlc_core_tpu\b", "dmlc_core_tpu_torch", src)
    mod = types.ModuleType(f"_port_{fname[:-3]}")
    mod.__file__ = os.path.join(TESTS, fname)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def export(namespace, mod, classes=(), funcs=(), left_out=None):
    """``<name>_port`` in ``namespace`` for each class (a subclass with
    the ``left_out[name]`` methods set to None) and function of ``mod``."""
    left_out = left_out or {}
    for name in classes:
        namespace[f"{name}_port"] = type(
            f"{name}_port", (getattr(mod, name),),
            {m: None for m in left_out.get(name, ())})
    for name in funcs:
        namespace[f"{name}_port"] = getattr(mod, name)


def _cpu_default(device=None):
    return _device_resolve("cpu" if device is None else device)


_device_resolve = _device.resolve_device


def patch_cpu_default(monkeypatch):
    """``device=None`` resolves to the CPU in every loaded port module
    until ``monkeypatch`` is undone (a module-scoped fixture's own
    ``pytest.MonkeyPatch.context()``, or :func:`on_cpu`'s)."""
    for name, mod in list(sys.modules.items()):
        if (name.startswith("dmlc_core_tpu_torch")
                and getattr(mod, "resolve_device", None) is _device_resolve):
            monkeypatch.setattr(mod, "resolve_device", _cpu_default)


@pytest.fixture
def on_cpu(monkeypatch):
    """``device=None`` resolves to the CPU in every loaded port module."""
    patch_cpu_default(monkeypatch)
    yield
