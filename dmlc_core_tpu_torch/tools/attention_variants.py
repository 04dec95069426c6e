#!/usr/bin/env python3
"""Build variants of the flash-attention source and A/B them on one card.

    python3 dmlc_core_tpu_torch/tools/attention_variants.py A.cu B.cu ...

Each argument is a whole ``attention.cu`` (the checkout's
``ops/csrc/attention.cu``, or an edited copy of it) with the entry points
and C signatures of ``ops/_build.py``.  Each is compiled with the
checkout's ``nvcc`` flags plus ``-Xptxas -v`` (its registers per kernel
are printed, and the kernels in which ptxas inserted ``wgmma`` waits),
loaded with ``ctypes`` and swapped in under ``ops/attention.py``'s
wrappers.  Then, in two rounds, the second in reverse order, each variant
runs ``chip_smoke.py``'s ``ATTN_SHAPES`` against the plain versions with
its tolerances and its run-to-run identity, and at BERT-base's shapes the
device time of ``flash_fwd`` and ``flash_bwd_dkv`` (``chip_smoke``'s
``device_ms``).  One JSON line per variant; the card's name and power
limit first.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = 20


def build(path, _build):
    """``(ctypes library, {"regs": [...], "wgmma_waits": [...]})``."""
    out = os.path.join(_build.BUILD_DIR,
                       "variant_" + os.path.basename(path) + ".so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS["attention"],
                        "-Xptxas", "-v", "-o", out, path],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{path}: nvcc failed\n{r.stderr[-3000:]}")
    regs = re.findall(r"Used (\d+) registers", r.stderr)
    waits = sorted(set(re.findall(r"C75\d+\).*?function '\S*?(flash_\w+?ILi\d+)",
                                  r.stderr)))
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build.SIGNATURES["attention"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib, {"regs": regs, "wgmma_waits": waits}


def run(torch, c, A, name, lib, res):
    A._lib = lambda: lib
    for shape_name, shape, causal in c.ATTN_SHAPES:
        B, S, H, D = shape
        gen = torch.Generator(device="cuda")
        gen.manual_seed(c.SEED)
        qkv = torch.randn((3, B, S, H, D), device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = qkv.unbind(0)
        do = torch.randn((B, S, H, D), device="cuda",
                         generator=gen).to(torch.bfloat16)
        scale = D ** -0.5
        o, lse = A.flash_fwd_kernel(q, k, v, causal, scale)
        o2, _ = A.flash_fwd_kernel(q, k, v, causal, scale)
        o_p, lse_p = A.flash_fwd_plain(q, k, v, causal, scale)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = A.flash_bwd_dkv_kernel(q, k, v, do, lse, di, causal, scale)
        dk2, dv2 = A.flash_bwd_dkv_kernel(q, k, v, do, lse, di, causal,
                                          scale)
        dk_p, dv_p = A.flash_bwd_dkv_plain(q, k, v, do, lse, di, causal,
                                           scale)
        torch.cuda.synchronize()
        errs = [c.rel_err(o, o_p), c.rel_err(dk, dk_p), c.rel_err(dv, dv_p)]
        ok = (errs[0] <= c.O_TOL and errs[1] <= c.GRAD_TOL
              and errs[2] <= c.GRAD_TOL
              and c.max_abs_err(torch, lse, lse_p) <= c.LSE_TOL
              and torch.equal(o, o2) and torch.equal(dk, dk2)
              and torch.equal(dv, dv2))
        entry = res[name].setdefault(shape_name, {"ok": True, "errs": errs})
        entry["ok"] = entry["ok"] and ok
        if shape_name in c.ATTN_TIMED:
            for kname, fn in (
                    ("fwd_device_ms",
                     lambda: A.flash_fwd_kernel(q, k, v, causal, scale)),
                    ("dkv_device_ms",
                     lambda: A.flash_bwd_dkv_kernel(q, k, v, do, lse, di,
                                                    causal, scale))):
                entry.setdefault(kname, []).append(
                    c.device_ms(torch, fn, REPS))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as c
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.ops import attention as A
    from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA card", file=sys.stderr)
        return 1
    paths = sys.argv[1:]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps({"nvidia_smi": gpu_name_and_power_limit()}),
          flush=True)
    libs, res = {}, {}
    for path in paths:
        name = os.path.basename(path)
        libs[name], res[name] = build(path, _build)
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            run(torch, c, A, name, libs[name], res)
    for name, r in res.items():
        print(json.dumps({"variant": name, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
