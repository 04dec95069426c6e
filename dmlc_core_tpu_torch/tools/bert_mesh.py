"""BERT on a mesh of ranks: one worker process per rank.

Start it as ``world`` processes (``parallel.launch.run_ranks``, which
gives each the ``DMLC_*`` env ABI of its rank)::

    python -m dmlc_core_tpu_torch.tools.bert_mesh job.json

A job is a JSON dict:

* ``device`` (``cpu``, or a card such as ``cuda:0`` that every rank
  shares; the ranks join over gloo), ``threads`` (torch intra-op
  threads);
* ``bert`` — ``BERT`` keyword arguments shared by the runs;
* ``batch`` — a ``.npz`` of the global ``tokens``, ``labels``, ``mask``,
  or ``{"seed", "B", "S"}``: tokens drawn from ``default_rng(seed)``
  over the vocabulary, labels = tokens, a mask of ones;
* ``runs`` — ``[{"name", "mesh": MeshSpec sizes, "bert": keywords laid
  over the job's, "seed", "steps", "save"}]``: each run builds
  ``create_mesh`` over the world, the model with ``init_params(seed)``'s
  weights (or ``BERT.load_model`` of a run's ``"load"`` file), and takes
  ``steps`` steps on the global batch (with ``"chunk": k``, one warmup
  chunk then ``fit_chunked`` in chunks of ``k``); a run's
  ``"save_model"`` path gets ``save_model``'s file after the steps;
* ``reference`` (optional) — before it joins the group, rank 0 trains
  each run's model on ONE rank (``local_mesh``, no process group) from
  the same weights for the same steps, and holds the run against it;
* ``out`` — a directory.

Per run, rank 0 writes ``<name>.json``: the losses, each step's seconds,
steps/s over the steps after the first, the payload bytes this rank put
into collectives a step (``collectives.wire_bytes``, host-staged under
gloo), the flash kernels' launches during the steps (their counters set
to 0 just before and read just after), and with ``reference`` the
largest relative loss difference and absolute weight difference against
the one-rank run; with ``save``, ``<name>.npz`` holds the gathered
weights (``p:<key>``) and momentum (``m:<key>``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np


def _batch(spec, vocab: int):
    if isinstance(spec, str):
        z = np.load(spec)
        return z["tokens"], z["labels"], z["mask"]
    rng = np.random.default_rng(spec["seed"])
    tokens = rng.integers(0, vocab, size=(spec["B"], spec["S"]))
    return tokens, tokens.copy(), np.ones(tokens.shape, np.float32)


def _kw(job, run) -> Dict[str, Any]:
    return {**job.get("bert", {}), **run.get("bert", {})}


def _counts(A):
    return {"flash_fwd": A.flash_fwd_kernel.launches,
            "flash_bwd_dkv": A.flash_bwd_dkv_kernel.launches,
            "flash_bwd_dq": A.flash_bwd_dq_kernel.launches}


_DRAWN: Dict[str, Any] = {}


def _initial(model, seed: int):
    """``model.initial_params(seed)``, drawn once per parameter layout
    and seed in this process (the runs share their weights)."""
    key = json.dumps([model._param_shapes(), seed])
    if key not in _DRAWN:
        _DRAWN[key] = model.initial_params(seed)
    return _DRAWN[key]


def _references(job, device) -> Dict[str, Any]:
    """Each run's one-rank losses and final weights (rank 0, before the
    group exists: ``local_mesh`` is this process alone)."""
    import torch

    from dmlc_core_tpu_torch.models import BERT

    refs, cache = {}, {}
    for run in job["runs"]:
        kw = _kw(job, run)
        # one rank has no sequence axis: sp_method does not change its run
        key = json.dumps([{k: v for k, v in kw.items() if k != "sp_method"},
                          run.get("seed", 0), run["steps"]], sort_keys=True)
        if key not in cache:
            model = BERT(device=device, **kw)
            host = _initial(model, run.get("seed", 0))
            model.params_from_numpy(host)
            batch = _batch(job["batch"], model.param.vocab_size)
            losses = [model.train_step(*batch) for _ in range(run["steps"])]
            cache[key] = (losses, model.gather_params()[0])
            del model
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        refs[run["name"]] = cache[key]
    return refs


def run_worker(job: Dict[str, Any]) -> None:
    import torch

    from dmlc_core_tpu_torch.models import BERT
    from dmlc_core_tpu_torch.ops import attention as A
    from dmlc_core_tpu_torch.parallel import collectives as coll
    from dmlc_core_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    torch.set_num_threads(int(job.get("threads", 1)))
    rank = int(os.environ.get("DMLC_TASK_ID", "0"))
    dev = job.get("device", "cpu")
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    out = job["out"]
    refs = _references(job, dev) if job.get("reference") and rank == 0 \
        else {}
    coll.init(backend="gloo")
    for run in job["runs"]:
        name = run["name"]
        mesh = create_mesh(MeshSpec(**run["mesh"]))
        if "load" in run:
            model = BERT.load_model(run["load"], mesh=mesh, device=dev)
        else:
            model = BERT(mesh=mesh, device=dev, **_kw(job, run))
            model.params_from_numpy(_initial(model, run.get("seed", 0)))
        batch = _batch(job["batch"], model.param.vocab_size)
        coll.barrier()
        for fn in (A.flash_fwd_kernel, A.flash_bwd_dkv_kernel,
                   A.flash_bwd_dq_kernel):
            fn.launches = 0
        losses, secs, wire = [], [], []
        if "chunk" in run:
            k = run["chunk"]
            loss, t, _ = model.fit_chunked(*batch, n_steps=run["steps"] - k,
                                           chunk=k, warmup_chunks=1)
            losses, secs, wire = [loss], [t], [0]
        for _ in range(0 if "chunk" in run else run["steps"]):
            coll.reset_wire_bytes()
            t0 = time.perf_counter()
            losses.append(model.train_step(*batch))
            secs.append(time.perf_counter() - t0)
            wire.append(coll.wire_bytes())
        launches = _counts(A)
        if "save_model" in run:
            model.save_model(run["save_model"])
        params, opt = model.gather_params()
        rec = {"name": name, "mesh": mesh.shape, "rank": rank,
               "world": coll.world_size(), "backend": "gloo",
               "device": dev, "losses": losses, "step_seconds": secs,
               "steps_per_sec": ((len(secs) - 1) / sum(secs[1:])
                                 if len(secs) > 1 else
                                 1.0 / secs[0] if secs else None),
               "wire_bytes_per_step": wire[-1] if wire else 0,
               "launches": launches}
        if name in refs:
            ref_losses, ref_params = refs[name]
            rec["ref_losses"] = ref_losses
            rec["loss_max_rel_diff"] = max(
                abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            rec["param_max_abs_diff"] = max(
                float(np.abs(params[k] - ref_params[k]).max())
                for k in ref_params)
            rec["finite"] = bool(np.all(np.isfinite(losses)) and all(
                np.isfinite(v).all() for v in params.values()))
        if rank == 0:
            if run.get("save"):
                np.savez(os.path.join(out, f"{name}.npz"),
                         **{f"p:{k}": v for k, v in params.items()},
                         **{f"m:{k}": v for k, v in opt.items()})
            with open(os.path.join(out, f"{name}.json"), "w") as f:
                json.dump(rec, f)
        del model, params, opt
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        coll.barrier()
    coll.finalize()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        run_worker(json.load(f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
