"""Configuration 4's proxy: a ``dist_sync`` KVStore on a BERT-base-shaped
gradient set, bucketed against per-key.

    BENCH_KV_DEVICES=4 python -m dmlc_core_tpu_torch.tools.bench_kvstore --device cuda

The port's counterpart of the repository's ``scripts/bench_kvstore.py``:
one step pushes every key and pulls every key (the sync and the SGD
update); the per-key mode is ``bucket_bytes=1`` (every key its own
collective), what the store did before bucketing.  The key set is
BERT-base's parameter inventory (199 keys) at ``BENCH_KV_HIDDEN`` (128)
and ``BENCH_KV_VOCAB`` (4,000), JAX's knobs and defaults (the contrast
under test is the collective COUNT, which the 199-key structure fixes;
``BENCH_KV_HIDDEN=768 BENCH_KV_VOCAB=30522`` is the full 110M-parameter
set), ``BENCH_KV_STEPS`` (5) timed steps after one warm step.

The workers are ``BENCH_KV_DEVICES`` processes of one group (JAX: virtual
devices of one process): ``--device cuda`` (the default) one a card over
NCCL, ``cuda:<rank>`` (default: every visible card; more than there are
raises); ``--device cpu`` gloo ranks on the host (default 8, JAX's);
``--device cuda:K`` gloo ranks sharing card K.  Each rank pushes its own
gradient, the values ``rng(0)`` draws ``/ W`` (JAX's), from rank ``r``'s
slice of them.  Prints one JSON line per mode, JAX's fields: collectives
per step, steps/s, the sync alone (``_sync_bucketed``, no update) in ms,
and the bus rate of a ring all-reduce of the gradient bytes,
``2·(n−1)/n · S`` over the sync's seconds (null on one worker).  The
port's dist_sync collective is an all-gather and a rank-order fold (the
store's bytes do not depend on the ring's order), which moves ``(n−1)/n
· n·S`` bytes into each worker: the bus rate is the all-reduce
convention of BASELINE.md's target line, not the wire's bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

RANK_TIMEOUT = 900


def bert_base_shapes(layers: int = 12, hidden: int = 768, vocab: int = 30522):
    """The BERT-base parameter inventory (~110M params, 199 tensors)."""
    shapes = [("embed.word", (vocab, hidden)),
              ("embed.pos", (512, hidden)),
              ("embed.type", (2, hidden)),
              ("embed.ln.g", (hidden,)), ("embed.ln.b", (hidden,))]
    for i in range(layers):
        p = f"l{i}."
        shapes += [
            (p + "q.w", (hidden, hidden)), (p + "q.b", (hidden,)),
            (p + "k.w", (hidden, hidden)), (p + "k.b", (hidden,)),
            (p + "v.w", (hidden, hidden)), (p + "v.b", (hidden,)),
            (p + "o.w", (hidden, hidden)), (p + "o.b", (hidden,)),
            (p + "ln1.g", (hidden,)), (p + "ln1.b", (hidden,)),
            (p + "ffn1.w", (hidden, 4 * hidden)), (p + "ffn1.b", (4 * hidden,)),
            (p + "ffn2.w", (4 * hidden, hidden)), (p + "ffn2.b", (hidden,)),
            (p + "ln2.g", (hidden,)), (p + "ln2.b", (hidden,)),
        ]
    shapes += [("pool.w", (hidden, hidden)), ("pool.b", (hidden,))]
    return shapes


def _rank(out: Path, device: str, backend: str) -> None:
    """One worker (``--rank-worker OUT``); rank 0 writes the lines."""
    import torch

    from dmlc_core_tpu_torch.parallel import collectives as coll
    from dmlc_core_tpu_torch.parallel.kvstore import KVStore

    rank = int(os.environ["DMLC_TASK_ID"])
    if device == "cuda":
        device = f"cuda:{rank}"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    coll.init(backend=backend)
    W = coll.world_size()
    steps = int(os.environ.get("BENCH_KV_STEPS", 5))
    hidden = int(os.environ.get("BENCH_KV_HIDDEN", 128))
    vocab = int(os.environ.get("BENCH_KV_VOCAB", 4000))
    shapes = bert_base_shapes(hidden=hidden, vocab=vocab)
    keys = [k for k, _ in shapes]
    n_params = sum(int(np.prod(s)) for _, s in shapes)
    rng = np.random.default_rng(0)
    # JAX's draws, [W, *shape] / W a key; this rank pushes its slice
    grads = {k: torch.from_numpy(
        (rng.normal(size=(W, *s)).astype(np.float32) / W)[rank]).to(dev)
        for k, s in shapes}
    bus_bytes = 2 * (W - 1) / W * n_params * 4

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    lines = []
    for label, bucket_bytes in (("per-key", 1), ("bucketed", 64 << 20)):
        kv = KVStore.create("dist_sync", learning_rate=0.01,
                            bucket_bytes=bucket_bytes, device=dev)
        kv.init(keys, [np.zeros(s, np.float32) for _, s in shapes])
        kv.push(keys, [grads[k] for k in keys])        # first use of each op
        kv.pull(keys)
        # the sync alone (no update): what the bus-rate target compares
        res = kv._sync_bucketed(dict(grads))
        sync()
        coll.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            res = kv._sync_bucketed(dict(grads))
        sync()
        dt_sync = (time.perf_counter() - t0) / steps
        kv.stats = {"sync_calls": 0, "keys_synced": 0}
        coll.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            kv.push(keys, [grads[k] for k in keys])
            res = kv.pull(keys)
        sync()
        dt = time.perf_counter() - t0
        del res
        lines.append({
            "mode": label,
            "keys": len(shapes),
            "params": n_params,
            "workers": W,
            "collectives_per_step": kv.stats["sync_calls"] // steps,
            "steps_per_sec": round(steps / dt, 3),
            "grad_mb_per_step": round(n_params * 4 / 1e6, 1),
            "sync_ms": round(dt_sync * 1e3, 2),
            "allreduce_bus_mb_per_step": round(bus_bytes / 1e6, 1),
            "bus_gbps": (round(bus_bytes / dt_sync / 1e9, 3)
                         if W > 1 else None),
            "bus_gbps_incl_update": (round(bus_bytes * steps / dt / 1e9, 3)
                                     if W > 1 else None),
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device": str(dev) if W == 1 else device,
            "backend": backend,
        })
    if rank == 0:
        (out / "lines.json").write_text(json.dumps(lines))
    coll.barrier()
    coll.finalize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (a worker a card, NCCL), cpu or cuda:K (gloo "
                         "workers sharing card K)")
    ap.add_argument("--rank-worker", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        out, device, backend = args.rank_worker
        _rank(Path(out), device, backend)
        return 0
    import torch

    from dmlc_core_tpu_torch.base.logging import CHECK
    from dmlc_core_tpu_torch.parallel.launch import run_ranks
    from dmlc_core_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)          # raises without a GPU
    if dev.type == "cpu":
        n, backend = int(os.environ.get("BENCH_KV_DEVICES", 8)), "gloo"
    elif args.device == "cuda":
        cards = torch.cuda.device_count()
        n = int(os.environ.get("BENCH_KV_DEVICES", cards))
        CHECK(n <= cards, f"bench_kvstore --device cuda: {n} workers asked "
              f"for, {cards} cards visible (one a card; --device cuda:K "
              f"shares card K)")
        backend = "nccl"
    else:
        n, backend = int(os.environ.get("BENCH_KV_DEVICES", 8)), "gloo"
    device = args.device if dev.type == "cuda" else "cpu"
    d = Path(tempfile.mkdtemp(prefix="bench_kvstore_"))
    try:
        run_ranks([sys.executable, "-m",
                   "dmlc_core_tpu_torch.tools.bench_kvstore", "--rank-worker",
                   str(d), device, backend], n, RANK_TIMEOUT, d / "logs")
        lines = json.loads((d / "lines.json").read_text())
    finally:
        shutil.rmtree(d, ignore_errors=True)
    smi = None
    if dev.type == "cuda":
        from dmlc_core_tpu_torch.utils.device import gpu_name_and_power_limit

        smi = gpu_name_and_power_limit()
    for line in lines:
        if smi:
            line["nvidia_smi"] = smi
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
