"""The port's small base and I/O modules (``base/common.py``,
``base/config.py``, ``base/thread_local.py``, ``base/wire_schemas.py``,
``utils/memory.py``, ``io/json_io.py``, ``io/thread_group.py``) and the
ones they sit beside, on the CPU.

The JAX package's own suites are loaded against the port (``*_port``):
``tests/test_base.py`` (logging and the CHECKs, registry, parameter,
env, config, ``split``, the memory pools; the names it takes from the
JAX package's top level come from the port's modules that define them),
``tests/test_io.py`` (URIs, memory streams,
``Stream.create``, the serializer, ``json_io``, the blocking queue, the
threaded iterator, RecordIO, the input splits, ``Stream.as_file``) and
``tests/test_concurrency_ext.py`` (``ThreadGroup``, ``ThreadLocalStore``,
the tracer and the annotations), each whole but for ``test_base.py``'s
tests of what the port's copies of ``base/parameter.py``,
``base/registry.py`` and ``base/timer.py`` do not hold (they are the
parts of those modules the port uses): ``Parameter``'s JSON save and
load, ``update_dict``, field docs, ``__doc__`` and hash
(``TestParameter``'s ``test_dict_fields_docs``, ``test_update_dict``,
``test_json_round_trip``, ``test_hashable_for_jit_static_arg``;
``test_param_doc_string``, ``test_param_hashable_with_list_field``),
``FunctionRegEntry`` (``TestRegistry.test_register_find_list``) and
``Timer`` (``TestTimer``).

The port's own check: the PS wire schemas are the JAX package's, and the
``base`` and ``io`` packages export the JAX package's names for these
modules.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmlc_core_tpu.base as jax_base  # noqa: E402
import dmlc_core_tpu.io as jax_io  # noqa: E402
import dmlc_core_tpu_torch.base as port_base  # noqa: E402
import dmlc_core_tpu_torch.io as port_io  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402
from dmlc_core_tpu.base import wire_schemas as jax_wire  # noqa: E402
from dmlc_core_tpu_torch.base import wire_schemas  # noqa: E402

_BASE = load_port("test_base.py", [(
    "from dmlc_core_tpu import (\n"
    "    CHECK,\n"
    "    CHECK_EQ,\n"
    "    CHECK_GE,\n"
    "    CHECK_LT,\n"
    "    CHECK_NOTNULL,\n"
    "    Error,\n"
    "    LOG,\n"
    "    Parameter,\n"
    "    Registry,\n"
    "    field,\n"
    "    get_env,\n"
    "    get_time,\n"
    ")\n",
    "from dmlc_core_tpu.base.logging import (CHECK, CHECK_EQ, CHECK_GE,\n"
    "                                        CHECK_LT, CHECK_NOTNULL, Error,\n"
    "                                        LOG)\n"
    "from dmlc_core_tpu.base.parameter import Parameter, field, get_env\n"
    "from dmlc_core_tpu.base.registry import Registry\n"
    "from dmlc_core_tpu.base.timer import get_time\n"),
    ("from dmlc_core_tpu.base.timer import Timer\n", "")])
#: tests of the parts of the JAX package's parameter, registry and timer
#: that the port's copies leave out (they hold what the port uses)
_BASE_LEFT_OUT = {
    "TestParameter": ("test_dict_fields_docs", "test_update_dict",
                      "test_json_round_trip",
                      "test_hashable_for_jit_static_arg"),
    "TestRegistry": ("test_register_find_list",)}
export(globals(), _BASE,
       [n for n in dir(_BASE) if n.startswith("Test") and n != "TestTimer"],
       [n for n in dir(_BASE) if n.startswith("test_") and n not in (
           "test_param_doc_string", "test_param_hashable_with_list_field")],
       left_out=_BASE_LEFT_OUT)
_IO = load_port("test_io.py")
export(globals(), _IO, [n for n in dir(_IO) if n.startswith("Test")],
       [n for n in dir(_IO) if n.startswith("test_")])
_CONC = load_port("test_concurrency_ext.py")
export(globals(), _CONC, funcs=[n for n in dir(_CONC)
                                if n.startswith("test_")])


def test_wire_schemas_are_the_jax_packages():
    names = [n for n in dir(jax_wire) if n.isupper()]
    assert names
    for n in names:
        assert getattr(wire_schemas, n) == getattr(jax_wire, n), n


def test_package_exports_are_the_jax_packages():
    for jax_pkg, port_pkg in ((jax_base, port_base), (jax_io, port_io)):
        want = {n for n in dir(jax_pkg) if not n.startswith("_")
                and not isinstance(getattr(jax_pkg, n), type(jax_base))}
        got = {n for n in dir(port_pkg) if not n.startswith("_")
               and not isinstance(getattr(port_pkg, n), type(port_base))}
        assert want <= got, sorted(want - got)
