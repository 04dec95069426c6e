"""The port's native host library (``cpp/`` over ``base/_native_build.py``,
``data/_native.py``, ``io/_native_io.py``, ``io/lockfree.py``) on the CPU.

The JAX package's own suites are loaded against the port (``*_port``):
``tests/test_native_io.py`` (the RecordIO codec and the chunk reader),
``tests/test_lockfree.py`` (its live-engine check asks the port's build
helper for the library, where the JAX test looks for ``make -C cpp``'s
file) and ``tests/test_data.py`` whole (its parsers in both modes, native
and Python).

The port's own checks:

* the library builds on first use under ``build/native_<hash>/``, once,
  and nothing is written into ``cpp/``; without a compiler it is absent
  and the parsers take the Python route (no native call counted); a
  failed build raises;
* the native libsvm, csv and libfm parses and the RecordIO encode and
  decode are bit-equal to the port's Python route and to the JAX
  package's native results on the same bytes (its library built by
  ``cpp/Makefile`` in a scratch copy of ``cpp/``);
* each native entry counts its calls, and only its own.

Where no C++ compiler is found the native library is absent and the
native tests skip, as the JAX package's do.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dmlc_core_tpu.data._native as jax_native  # noqa: E402
import dmlc_core_tpu.io._native_io as jax_native_io  # noqa: E402
from _torch_suites import export, load_port  # noqa: E402
from dmlc_core_tpu_torch.base import _native_build  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.data import Parser, _native  # noqa: E402
from dmlc_core_tpu_torch.data.parsers import (  # noqa: E402
    _py_parse_csv, _py_parse_libfm, _py_parse_libsvm)
from dmlc_core_tpu_torch.io import _native_io  # noqa: E402
from dmlc_core_tpu_torch.io.memory_io import MemoryStringStream  # noqa: E402
from dmlc_core_tpu_torch.io.recordio import (  # noqa: E402
    RECORDIO_MAGIC_BYTES, RecordIOChunkReader, RecordIOWriter, decode_chunk,
    encode_records)


@pytest.fixture
def cxx():
    """The C++ compiler the build helper uses; the test skips without one
    (the native library is absent then)."""
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        pytest.skip("no C++ compiler: the native library is absent")
    return found


_NATIVE_IO = load_port("test_native_io.py")
export(globals(), _NATIVE_IO, funcs=[n for n in dir(_NATIVE_IO)
                                     if n.startswith("test_")])
_LOCKFREE = load_port("test_lockfree.py", [(
    "    so = os.path.join(os.path.dirname(os.path.dirname(\n"
    "        os.path.abspath(__file__))), \"build\", \"libdmlctpu.so\")\n"
    "    if not os.path.exists(so):\n"
    "        pytest.skip(\"native lib not built (make -C cpp)\")\n",
    "    from dmlc_core_tpu.base import _native_build\n"
    "    if _native_build.library_path() is None:\n"
    "        pytest.skip(\"native library absent (no C++ compiler)\")\n")])
export(globals(), _LOCKFREE, funcs=[n for n in dir(_LOCKFREE)
                                    if n.startswith("test_")])
_DATA = load_port("test_data.py")
export(globals(), _DATA, [n for n in dir(_DATA) if n.startswith("Test")],
       [n for n in dir(_DATA) if n.startswith("test_")])
parse_mode = _DATA.parse_mode


# -- the JAX package's native library, built by cpp/Makefile ---------------

@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """``make`` of ``libdmlctpu.so`` in a scratch copy of ``cpp/``, loaded
    by the JAX package's bindings for this module's tests."""
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler: the native library is absent")
    d = tmp_path_factory.mktemp("jaxcpp")
    shutil.copytree(os.path.join(ROOT, "cpp"), d / "cpp")
    res = subprocess.run(["make", "-C", str(d / "cpp"),
                          "../build/libdmlctpu.so"], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    so = str(d / "build" / "libdmlctpu.so")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_SO_PATHS", [so])
    mp.setattr(jax_native, "_lib", None)
    mp.setattr(jax_native_io, "_SO_PATHS", [so])
    mp.setattr(jax_native_io, "_lib", None)
    mp.setattr(jax_native_io, "_load_failed", False)
    assert jax_native.native_available()
    assert jax_native_io.native_io_available()
    yield so
    mp.undo()


def _floats(rng, n):
    """Decimals as a user writes them: ``%.9g`` of f32, short, exponent."""
    x = rng.standard_normal(n).astype(np.float32) * np.float32(1e3)
    return [f"{v:.9g}" if i % 3 == 0 else
            f"{v:.4f}" if i % 3 == 1 else f"{v:.6e}"
            for i, v in enumerate(x)]


def _libsvm_text(seed):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(300):
        n = int(rng.integers(0, 12))
        idx = np.sort(rng.choice(5000, n, replace=False))
        vals = _floats(rng, n)
        head = ("+1" if i % 7 == 0 else f"{int(rng.integers(0, 2))}")
        if seed % 2:
            head += f" qid:{i // 10}"
        feats = " ".join(f"{j}:{v}" for j, v in zip(idx, vals))
        lines.append(f"{head} {feats}".rstrip())
    return ("\n".join(lines) + "\n").encode()


def _csv_text(seed):
    rng = np.random.default_rng(seed)
    rows = [",".join(_floats(rng, 6)) for _ in range(300)]
    return ("\n".join(rows) + "\n").encode()


def _libfm_text(seed):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(300):
        n = int(rng.integers(1, 8))
        vals = _floats(rng, n)
        feats = " ".join(f"{int(rng.integers(0, 9))}:"
                         f"{int(rng.integers(0, 900))}:{v}" for v in vals)
        lines.append(f"{int(rng.integers(0, 2))} {feats}")
    return ("\n".join(lines) + "\n").encode()


CASES = {
    "libsvm": (_libsvm_text, "parse_libsvm",
               lambda b: _py_parse_libsvm(b), ()),
    "csv": (_csv_text, "parse_csv",
            lambda b: _py_parse_csv(b, ",", 0, 5), (",", 0, 5)),
    "libfm": (_libfm_text, "parse_libfm",
              lambda b: _py_parse_libfm(b), ()),
}
KEYS = ("offset", "label", "index", "value", "weight", "qid", "field")


def _same(a, b, what):
    for k in KEYS:
        va, vb = a.get(k), b.get(k)
        assert (va is None) == (vb is None), (what, k)
        if va is not None:
            va = np.asarray(va)
            assert va.tobytes() == np.asarray(vb, va.dtype).tobytes(), (
                what, k)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fmt", sorted(CASES))
def test_native_parse_is_python_and_jax_native(fmt, seed, jax_lib):
    text, entry, py, args = CASES[fmt]
    blob = text(seed)
    ours = getattr(_native, entry)(blob, *args)
    _same(ours, py(blob), "python route")
    _same(ours, getattr(jax_native, entry)(blob, *args), "JAX native")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recordio_codec_is_python_and_jax_native(seed, jax_lib):
    rng = np.random.default_rng(seed)
    records = [rng.bytes(int(rng.integers(0, 300))) for _ in range(200)]
    records[3] = RECORDIO_MAGIC_BYTES * 2 + b"x"         # escaped magics
    records[7] = b"a" + RECORDIO_MAGIC_BYTES
    buf = MemoryStringStream()
    w = RecordIOWriter(buf)
    for r in records:
        w.write_record(r)
    py = bytes(buf.data)
    ours = _native_io.recordio_encode(records)
    assert ours == py == jax_native_io.recordio_encode(records)
    assert encode_records(records) == py
    decoded = _native_io.recordio_decode(py)
    assert decoded == list(RecordIOChunkReader(py)) == records
    assert decoded == jax_native_io.recordio_decode(py)
    assert decode_chunk(py) == records


def test_routes_count_their_native_calls(cxx, tmp_path):
    path = tmp_path / "d.libsvm"
    path.write_bytes(_libsvm_text(0))
    _native.reset_calls()
    _native_io.reset_calls()
    blocks = list(Parser.create(str(path), format="libsvm"))
    assert sum(b.size for b in blocks) == 300
    assert _native.calls()["parse_libsvm"] == len(blocks)
    assert _native.calls()["parse_csv"] == _native.calls()["parse_libfm"] == 0
    got = _native_io.calls()
    assert got["prefetch_open"] == 1 and got["prefetch_chunks"] >= 1
    assert got["recordio_encode"] == got["recordio_decode"] == 0
    encode_records([b"a", b"b"])
    decode_chunk(encode_records([b"c"]))
    got = _native_io.calls()
    assert (got["recordio_encode"], got["recordio_decode"]) == (2, 1)


def test_build_is_cached_and_leaves_cpp_alone(cxx):
    before = sorted(os.listdir(os.path.join(ROOT, "cpp")))
    path = _native_build.library_path()
    assert path == _native_build.library_path()
    assert path.name == "libdmlctpu.so"
    assert path.parent.parent == _native_build.BUILD_ROOT
    assert path.parent.name.startswith("native_")
    assert _native_build.build(cxx) == path          # the cache, no rebuild
    assert sorted(os.listdir(os.path.join(ROOT, "cpp"))) == before


@pytest.fixture
def fresh(monkeypatch):
    """The build helper and the parse binding as if never asked."""
    monkeypatch.setattr(_native_build, "_PATH", {})
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_absent", False)
    monkeypatch.delenv("DMLC_TPU_NATIVE_LIB", raising=False)
    return monkeypatch


def test_absent_library_takes_the_python_route(fresh, tmp_path):
    fresh.setenv("CXX", "no-such-compiler-here")
    assert _native_build.library_path() is None
    assert not _native.native_available()
    path = tmp_path / "d.libsvm"
    blob = _libsvm_text(0)
    path.write_bytes(blob)
    _native.reset_calls()
    block = next(iter(Parser.create(str(path), format="libsvm")))
    assert _native.calls()["parse_libsvm"] == 0
    _same({k: getattr(block, k) for k in KEYS}, _py_parse_libsvm(blob),
          "python route")


def test_failed_build_raises(fresh, tmp_path):
    false = shutil.which("false")
    if false is None:
        pytest.skip("no `false` command to stand in for a broken compiler")
    fresh.setenv("CXX", false)
    fresh.setattr(_native_build, "BUILD_ROOT", tmp_path)
    with pytest.raises(Error, match="native library build failed"):
        _native_build.library_path()
    with pytest.raises(Error, match="native library build failed"):
        _native.native_available()
    assert not list(tmp_path.glob("native_*/libdmlctpu.so"))
