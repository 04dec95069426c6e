"""Build and bind the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface under ``build/torch_kernels/`` at the
root of the checkout, on first use, and loads through ``ctypes``.  The
library's name carries a hash of its source and flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import:
the CPU-only tests import every module of the package freely, and a
machine without ``nvcc`` fails only when a kernel is asked for.

A failed build raises; there is no fall back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from dmlc_core_tpu_torch.base.logging import LOG, log_fatal

__all__ = ["load_library", "build_all", "is_built", "BUILD_DIR",
           "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: each source's flags.  histogram and hist_floor: -fmad=false, no
#: multiply-add contraction, so every float operation rounds as its plain
#: PyTorch version's does (their kernels are held bit for bit).
#: attention: held by a tolerance, so contraction stays on.
NVCC_FLAGS: Dict[str, Tuple[str, ...]] = {
    "histogram": ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                  "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"),
    "hist_floor": ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"),
    "attention": ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                  "-O3", "-shared", "-Xcompiler", "-fPIC"),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

#: C signatures of each source's entry points (every one returns the
#: launch's cudaError_t as an int)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "histogram": {
        "dmlc_device_limits": (_P,),
        # bins, node, g, h; n; group rows, groups, n_groups, shared,
        # smem, chunks, rows_per_chunk, shift, qbits; S, N, n_bins;
        # scales; left_only; out, stream
        "dmlc_hist_accum": (_P, _P, _P, _P, _LL, _P, _P, _I, _I, _I, _I,
                            _LL, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P),
        "dmlc_descend": (_P, _P, _P, _P, _I, _LL, _P, _P, _P),
        # bins, node, feat, thr, by_node, g, h; n; group rows, groups,
        # n_groups, shared, smem, chunks, rows_per_chunk, shift, qbits,
        # cluster; F, n_prev, n_bins; scales; out, new_node, stream
        "dmlc_fused_descend": (_P, _P, _P, _P, _I, _P, _P, _LL, _P, _P, _I,
                               _I, _I, _I, _LL, _I, _I, _I, _I, _I, _I, _F,
                               _F, _P, _P, _P),
        "dmlc_hist_epilogue": (_P, _P, _P, _I, _LL, _D, _D, _P),
    },
    "hist_floor": {
        # bins, row stride, node, g, h; n_tiles, tile_rows, F, n_build,
        # hi, variant, tiles_per_run; partial, out, stream
        "dmlc_hist_floor": (_P, _LL, _P, _P, _P) + (_I,) * 7
                           + (_P, _P, _P),
    },
    "attention": {
        # q, k, v, o, lse; B, S, H, D; (batch, seq, head) strides of q,
        # k, v, o; scale, causal, stream
        "dmlc_flash_fwd": (_P,) * 5 + (_I,) * 4 + (_LL,) * 12
                          + (_F, _I, _P),
        # q, k, v, dO, lse, di, dk, dv; B, S, H, D; strides of q, k, v,
        # dO, dk, dv; scale, causal, stream
        "dmlc_flash_bwd_dkv": (_P,) * 8 + (_I,) * 4 + (_LL,) * 18
                              + (_F, _I, _P),
        # q, k, v, dO, lse, di, dq; B, S, H, D; strides of q, k, v, dO,
        # dq; scale, causal, stream
        "dmlc_flash_bwd_dq": (_P,) * 7 + (_I,) * 4 + (_LL,) * 15
                             + (_F, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    log_fatal("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
              "kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS[name]).encode()
    tag = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, float]]:
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library is already
    built: ``(process, temporary output, start time)``, or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS[name], "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, job) -> Path:
    """Wait for a :func:`_start` job; returns the library's path."""
    out = _lib_path(name)
    if job is None:
        return out
    proc, tmp, t0 = job
    _, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        log_fatal(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                  f"{stderr[-4000:]}")
    os.replace(tmp, out)       # atomic: concurrent builds agree
    LOG("INFO", "built %s in %.1f s", out.name, time.perf_counter() - t0)
    return out


def is_built(name: str) -> bool:
    """Whether ``csrc/<name>.cu``'s library is already built (a build
    cache hit for this source and flags)."""
    return _lib_path(name).exists()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path."""
    return _finish(name, _start(name))


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Build every source, one ``nvcc`` per source, all started together
    — the set-up step of a chip run."""
    jobs = [(name, _start(name)) for name in names]
    for name, job in jobs:
        _finish(name, job)     # raises on the first failed build


def load_library(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
