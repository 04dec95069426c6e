"""The port's copies of the JAX package's host data plane, held by the
JAX package's own tests run against both packages.

The relevant tests of ``tests/test_data.py``, ``tests/test_io.py`` and
``tests/test_external_memory.py`` are loaded twice from their source:
as written (``*_jax``), and with every ``dmlc_core_tpu`` module name
replaced by its ``dmlc_core_tpu_torch`` counterpart (``*_port``).  Left
out: what the port does not copy (``io/json_io.py``; the native parse
engine, so both run the pure-Python parse route; ``GBLinear``) and the
tests of ``HistGBT`` itself, which ``tests/test_torch_external.py``
holds against the JAX package.  The port's sketch runs with
``device="cpu"`` and takes torch tensors where the JAX one takes arrays.
"""

import os
import re
import sys
import types

import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)

torch.set_num_threads(2)


def _load(fname, port, subs=()):
    """``tests/<fname>`` as a module, for the JAX package or the port."""
    src = open(os.path.join(TESTS, fname)).read()
    if port:
        src = re.sub(r"\bdmlc_core_tpu\b", "dmlc_core_tpu_torch", src)
        for old, new in subs:
            assert old in src, old
            src = src.replace(old, new)
    tag = "port" if port else "jax"
    mod = types.ModuleType(f"_{tag}_{fname[:-3]}")
    mod.__file__ = os.path.join(TESTS, fname)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


# (file, port substitutions, classes, functions)
SUITES = [
    ("test_data.py",
     [("from dmlc_core_tpu_torch.data import _native\n",
       "_native = None  # the port parses in Python only\n")],
     ["TestRowBlock", "TestRowBlockContainer", "TestParsers",
      "TestRowBlockIter"],
     ["test_parse_uri_spec"]),
    ("test_io.py",
     [("from dmlc_core_tpu_torch.io.json_io import JSONObjectReadHelper, "
       "JSONReader, JSONWriter\n", "")],
     ["TestURI", "TestMemoryStreams", "TestStreamCreate", "TestSerializer",
      "TestBlockingQueue", "TestThreadedIter", "TestRecordIO",
      "TestInputSplitText", "TestInputSplitRecordIO", "TestIndexedRecordIO",
      "TestShuffleAndCache", "TestStreamAsFile"],
     ["test_input_split_semicolon_multipath",
      "test_split_multi_uri_url_query_semicolons",
      "test_as_file_close_after_stream_closed"]),
    ("test_external_memory.py",
     [("from dmlc_core_tpu_torch.models.histgbt import HistGBT\n", ""),
      ("    SketchAccumulator,\n    compute_cuts,\n)",
       "    SketchAccumulator as _Sketch,\n    compute_cuts as _cuts,\n)\n"
       "import functools, torch\n"
       "SketchAccumulator = functools.partial(_Sketch, device='cpu')\n"
       "def compute_cuts(x, **kw):\n"
       "    return _cuts(torch.from_numpy(np.ascontiguousarray(x)), **kw)\n")],
     ["TestSketchErrorBound", "TestSketchAccumulator"],
     []),
]

#: tests of what the port does not copy (the native parse engine)
NOT_COPIED = {"TestParsers": ["test_native_matches_python"]}

for _fname, _subs, _classes, _funcs in SUITES:
    for _port in (False, True):
        _mod = _load(_fname, _port, _subs)
        _tag = "port" if _port else "jax"
        for _name in _classes:
            globals()[f"{_name}_{_tag}"] = type(
                f"{_name}_{_tag}", (getattr(_mod, _name),),
                {m: None for m in NOT_COPIED.get(_name, ())})
        for _name in _funcs:
            globals()[f"{_name}_{_tag}"] = getattr(_mod, _name)


@pytest.fixture(params=["python"])
def parse_mode(request, monkeypatch):
    """``tests/test_data.py``'s parse-mode fixture, on the route both
    packages share: the JAX package with its native engine switched
    off; the port, which has only this route."""
    if request.cls.__name__.endswith("_jax"):
        from dmlc_core_tpu.data import _native

        monkeypatch.setattr(_native, "native_available", lambda: False)
    return request.param


del _fname, _subs, _classes, _funcs, _port, _mod, _tag, _name
