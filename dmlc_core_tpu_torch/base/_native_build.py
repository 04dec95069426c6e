"""Build the native host library (``cpp/``: parse, RecordIO, prefetch and
the lock-free queue) with the C++ compiler, on first use.

``cpp/fastparse.cc``, ``recordio.cc``, ``prefetch.cc`` and
``mpmc_queue.cc`` compile with ``cpp/Makefile``'s flags (``-fopenmp``
where the compiler links it) into
``build/native_<hash>/libdmlctpu.so`` at the root of the checkout.  The
hash covers the sources, the flags, the compiler's version and this
machine's CPU (``-march=native``), so an edited source rebuilds and a
library built for another machine is never loaded.  The sources are
read in place; nothing is written into ``cpp/``.  Nothing here runs at
import.

The library is optional, as in the JAX package: where no compiler is on
the ``PATH`` (``$CXX``, else ``g++``), it is absent and the callers take
their Python routes.  ``DMLC_TPU_NATIVE_LIB``
names a library built elsewhere, which is loaded as it is.  A build that
is asked for and fails raises; no caller goes on in Python then.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from dmlc_core_tpu_torch.base.logging import LOG, log_fatal

__all__ = ["library_path", "build", "gen_libsvm_path", "CPP_DIR",
           "BUILD_ROOT", "SOURCES"]

CPP_DIR = Path(__file__).resolve().parents[2] / "cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("fastparse.cc", "recordio.cc", "prefetch.cc", "mpmc_queue.cc")
#: ``cpp/Makefile``'s ``CXXFLAGS`` and ``LDFLAGS`` (``-fopenmp`` is added
#: where the compiler links it, :func:`_openmp`)
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra")
LDFLAGS = ("-shared",)

_LOCK = threading.Lock()
_PATH: Dict[str, Optional[Path]] = {}


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX") or "g++")


def _cpu_tag() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().split(b"\n")
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines
            if ln.startswith((b"model name", b"flags", b"Features"))]
    return b"\n".join(sorted(set(keep)))


def _openmp(cxx: str) -> bool:
    """Whether ``cxx`` builds and links a shared object with ``-fopenmp``.
    The Makefile's probe only preprocesses, which a compiler installed
    without its OpenMP runtime (no ``libgomp.spec``) passes and then fails
    to link; without OpenMP the parser runs on one thread."""
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "omp.cc")
        with open(src, "w") as f:
            f.write("#include <omp.h>\n"
                    "int dmlc_omp() { return omp_get_max_threads(); }\n")
        return subprocess.run(
            [cxx, "-fopenmp", *CXXFLAGS, *LDFLAGS, "-o",
             os.path.join(d, "omp.so"), src],
            capture_output=True).returncode == 0


def _flags(cxx: str) -> List[str]:
    return [*CXXFLAGS, *(["-fopenmp"] if _openmp(cxx) else []), *LDFLAGS]


def _out_path(cxx: str, flags: List[str]) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CPP_DIR / name).read_bytes())
    version = subprocess.run([cxx, "--version"], capture_output=True).stdout
    h.update(" ".join(flags).encode() + version + _cpu_tag())
    return BUILD_ROOT / f"native_{h.hexdigest()[:16]}" / "libdmlctpu.so"


def build(cxx: str) -> Path:
    """Compile the library with ``cxx`` unless it is already built for
    these sources, flags and CPU; returns its path.  Concurrent builders
    (processes) wait on one lock file and the first one builds."""
    flags = _flags(cxx)
    out = _out_path(cxx, flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *flags, "-o", str(tmp),
               *[str(CPP_DIR / s) for s in SOURCES], "-lpthread"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            log_fatal(f"native library build failed (rc {proc.returncode}):"
                      f" {' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        LOG("INFO", "built %s in %.1f s", out, time.perf_counter() - t0)
    return out


def library_path() -> Optional[Path]:
    """The native library's path, built on the first call; None where it
    is absent (no compiler).  Raises when the build fails."""
    override = os.environ.get("DMLC_TPU_NATIVE_LIB", "")
    if override:
        return Path(override)
    with _LOCK:
        if "lib" not in _PATH:
            cxx = _compiler()
            if cxx is None:
                LOG("INFO", "no C++ compiler on the PATH: the native "
                    "library is absent, parsing and RecordIO run in Python")
            _PATH["lib"] = build(cxx) if cxx else None
        return _PATH["lib"]


#: ``cpp/Makefile``'s flags for the LibSVM generator
GEN_FLAGS = ("-O2", "-std=c++17", "-Wall")


def gen_libsvm_path() -> Path:
    """The Criteo-shaped LibSVM generator (``cpp/gen_libsvm.cc``), built
    on the first call into ``build/gen_libsvm_<hash>/gen_libsvm`` with
    ``cpp/Makefile``'s flags (the hash covers the source, the flags and
    the compiler's version).  It is a build step, never a download:
    without a compiler it raises."""
    cxx = _compiler()
    if cxx is None:
        log_fatal("gen_libsvm: no C++ compiler on the PATH ($CXX or g++) "
                  "to build cpp/gen_libsvm.cc")
    src = CPP_DIR / "gen_libsvm.cc"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GEN_FLAGS).encode() + subprocess.run(
        [cxx, "--version"], capture_output=True).stdout)
    out = BUILD_ROOT / f"gen_libsvm_{h.hexdigest()[:16]}" / "gen_libsvm"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *GEN_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            log_fatal(f"gen_libsvm build failed (rc {proc.returncode}): "
                      f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out
