"""Production-shape transformer benchmark on one card: BERT-base,
Switch-MoE at capacity pressure and the GPipe ``PipelineLM``.

    python -m dmlc_core_tpu_torch.tools.bench_transformer

The port's counterpart of the repository's ``scripts/bench_transformer.py``
with its shapes, knobs and JSON fields: BERT-base (L12 / d768 / h12 /
ff3072, seq 512, vocab 30522, batch ``BENCH_T_BATCH`` 8), a 6-layer d512
Switch-MoE (8 experts, capacity factor 1.0: tokens an expert about its
capacity, so the overflow and padding paths run), and a 12-layer d512
``PipelineLM`` at batch 16 in 8 microbatches (one stage: the schedule and
its buffers still run).  Each trains ``BENCH_T_STEPS`` (30) steps through
its ``fit_chunked`` in chunks of ``BENCH_T_CHUNK`` (10) after a warmup
chunk, with each chunk's loss arrival time; ``BENCH_T_MODELS``
(``bert,moe,pipeline``) selects.  One JSON line per model; a model that
fails prints its error and the others still run (JAX's rule).

BERT and the MoE train on the one card's data axis alone (``BERT``'s
default mesh), so their attention at d_head 64 is the port's flash
kernels (``ops/csrc/attention.cu``: forward, dK·dV, dQ); each line
carries the launches of the three during that model's run.  The JAX
script names every axis at size 1 (``create_mesh(MeshSpec(data=1))``),
which sends its attention through the ring of the ``seq`` axis even on
one chip; the one-card path a user takes is the flash kernels'.
``approx_mfu`` is null, as ``bench.py``'s peak table has no entry for the
card.  It runs on the card unless ``--device cpu`` is given, and raises
without one;
``--smoke`` cuts every model to a few narrow layers at sequence 32 (a
rehearsal, the tests' size: on the CPU the attention is the dense
oracle and no kernel launches).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

#: ``--smoke``: every model cut to this (layers, d_model, heads, d_ff,
#: vocab, seq)
SMOKE = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab_size=64,
             max_len=32)


def _mfu(flops_per_sec, platform):
    from dmlc_core_tpu_torch.bench import _PEAK_BF16

    peak = _PEAK_BF16.get(platform, 0)
    return round(flops_per_sec / peak, 4) if peak else None


def _mem_stats(dev):
    import torch

    if dev.type != "cuda":
        return {"hbm_peak_mb": None, "hbm_in_use_mb": None}
    return {"hbm_peak_mb": round(torch.cuda.max_memory_allocated(dev) / 1e6,
                                 1),
            "hbm_in_use_mb": round(torch.cuda.memory_allocated(dev) / 1e6,
                                   1)}


def _platform(dev):
    return "gpu" if dev.type == "cuda" else "cpu"


def _flash_launches():
    from dmlc_core_tpu_torch.ops import attention as A

    return {"flash_fwd": A.flash_fwd_kernel.launches,
            "flash_bwd_dkv": A.flash_bwd_dkv_kernel.launches,
            "flash_bwd_dq": A.flash_bwd_dq_kernel.launches}


def _run(dev, fit):
    """``fit()``'s result with the flash launches it made and the card's
    peak memory over it."""
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _flash_launches()
    loss, secs, chunk_times = fit()
    after = _flash_launches()
    return loss, secs, chunk_times, {k: after[k] - before[k] for k in after}


def _tokens(vocab, B, S):
    rng = np.random.default_rng(0)
    return rng.integers(0, vocab, size=(B, S))


def bench_bert(dev, steps, chunk, smoke=False):
    from dmlc_core_tpu_torch.models.bert import BERT

    B = int(os.environ.get("BENCH_T_BATCH", 8))
    kw = dict(SMOKE) if smoke else {}
    model = BERT(device=dev, **kw)       # BERT-base defaults
    S = model.param.max_len
    model.init_params(0)
    n_params = sum(int(v.numel()) for v in model.params.values())
    tokens = _tokens(model.param.vocab_size, B, S)
    loss, secs, chunk_times, launches = _run(dev, lambda: model.fit_chunked(
        tokens, tokens.copy(), np.ones((B, S), np.float32), n_steps=steps,
        chunk=chunk))
    flops = 6 * n_params * B * S      # fwd+bwd matmul estimate
    return {
        "model": "bert_base", "layers": model.param.n_layers,
        "d_model": model.param.d_model, "seq": S, "batch": B,
        "params_m": round(n_params / 1e6, 1),
        "steps": steps, "seconds": round(secs, 3),
        "steps_per_sec": round(steps / secs, 3),
        "tokens_per_sec": round(B * S * steps / secs),
        "approx_mfu": _mfu(flops * steps / secs, _platform(dev)),
        "final_loss": round(loss, 4),
        "chunk_times": [(d, round(t, 3)) for d, t in chunk_times],
        "flash_launches": launches,
        **_mem_stats(dev),
    }


def bench_moe(dev, steps, chunk, smoke=False):
    from dmlc_core_tpu_torch.models.bert import BERT

    # capacity pressure: tokens an expert ≈ its capacity at cf 1.0, so the
    # dispatch's overflow and padding paths run
    B = int(os.environ.get("BENCH_T_BATCH", 8))
    kw = (dict(SMOKE) if smoke else
          dict(n_layers=6, d_model=512, n_heads=8, d_ff=2048))
    model = BERT(device=dev, ffn_type="moe", n_experts=8,
                 capacity_factor=1.0, **kw)
    S = model.param.max_len
    model.init_params(0)
    n_params = sum(int(v.numel()) for v in model.params.values())
    tokens = _tokens(model.param.vocab_size, B, S)
    loss, secs, chunk_times, launches = _run(dev, lambda: model.fit_chunked(
        tokens, tokens.copy(), np.ones((B, S), np.float32), n_steps=steps,
        chunk=chunk))
    return {
        "model": "switch_moe", "layers": model.param.n_layers,
        "d_model": model.param.d_model, "seq": S, "batch": B,
        "experts": 8, "capacity_factor": 1.0,
        "params_m": round(n_params / 1e6, 1),
        "steps": steps, "seconds": round(secs, 3),
        "steps_per_sec": round(steps / secs, 3),
        "tokens_per_sec": round(B * S * steps / secs),
        "final_loss": round(loss, 4),
        "chunk_times": [(d, round(t, 3)) for d, t in chunk_times],
        "flash_launches": launches,
        **_mem_stats(dev),
    }


def bench_pipeline(dev, steps, chunk, smoke=False):
    from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from dmlc_core_tpu_torch.parallel.pipeline import PipelineLM

    # 8 microbatches through the GPipe schedule (one stage: the schedule,
    # its buffers and the stage hand-offs still run)
    B, n_micro = (8, 4) if smoke else (16, 8)
    kw = (dict(SMOKE) if smoke else
          dict(n_layers=12, d_model=512, n_heads=8, d_ff=2048,
               vocab_size=30522, max_len=512))
    mesh = create_mesh(MeshSpec(data=1, pipe=1), axis_names=("data", "pipe"))
    model = PipelineLM(mesh=mesh, device=dev, n_micro=n_micro, **kw)
    S, vocab = model.param.max_len, model.param.vocab_size
    model.init_params(0)
    tokens = _tokens(vocab, B, S).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    loss, secs, chunk_times, _ = _run(dev, lambda: model.fit_chunked(
        tokens, tokens.copy(), mask, n_steps=steps, chunk=chunk))
    return {
        "model": "pipeline_lm", "layers": model.param.n_layers,
        "d_model": model.param.d_model, "seq": S, "batch": B,
        "n_micro": n_micro,
        "steps": steps, "seconds": round(secs, 3),
        "steps_per_sec": round(steps / secs, 3),
        "tokens_per_sec": round(B * S * steps / secs),
        "final_loss": round(float(loss), 4),
        "chunk_times": [(d, round(t, 3)) for d, t in chunk_times],
        **_mem_stats(dev),
    }


FNS = {"bert": bench_bert, "moe": bench_moe, "pipeline": bench_pipeline}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="a few narrow layers at sequence 32")
    args = ap.parse_args(argv)
    from dmlc_core_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)          # raises without a GPU
    smi = None
    if dev.type == "cuda":
        from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

        smi = gpu_name_and_power_limit()
    steps = int(os.environ.get("BENCH_T_STEPS", 30))
    chunk = int(os.environ.get("BENCH_T_CHUNK", 10))
    models = os.environ.get("BENCH_T_MODELS", "bert,moe,pipeline").split(",")
    failed = False
    for name in models:
        try:
            out = FNS[name.strip()](dev, steps, chunk, smoke=args.smoke)
        except Exception as e:  # noqa: BLE001 — report traps, keep going
            failed = True
            out = {"model": name.strip(),
                   "error": f"{type(e).__name__}: {e}"[:600]}
        out["platform"] = _platform(dev)
        if smi:
            out["nvidia_smi"] = smi
        print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
