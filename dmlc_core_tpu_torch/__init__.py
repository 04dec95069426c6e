"""dmlc_core_tpu_torch — the PyTorch / CUDA port of ``dmlc_core_tpu``.

A package of its own beside the JAX package, for one NVIDIA H100
(Hopper, sm_90a).  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``dmlc_core_tpu``: the modules it needs from there (logging,
parameter, registry, stream, serializer) are its own copies.  Its layout
mirrors the JAX package's, so each module's counterpart has the same
path.  The Pallas TPU kernels on the ported path are hand-written CUDA
kernels here (``ops/csrc``), each beside a plain PyTorch version of the
same function that the CPU runs.

Ported so far: dense in-core ``HistGBT`` — depth-wise and loss-guide
growth, int4 bin packing and feature bundling, fit, predict, save/load
(model files interchangeable with the JAX package's), data parallel over
a ``torch.distributed`` group, with its ranking objectives, out-of-core
training and the sparse engine; ``models.GBLinear``, ``models.FM`` and
the sklearn-style wrappers; ``models.BERT`` masked-LM training on one
GPU with hand-written flash-attention kernels; the serving tier
(``serve``: runner, batcher, registry, HTTP frontend and client;
``serve.tenancy``, ``serve.fleet``) with the ``tracker``, ``launch``
and metrics-spool (``base.metrics_agg``) tiers under it; online
learning (``stream``: the tailer, the online trainer, the publisher);
distributed state (``parallel.kvstore``, the parameter server
``parallel.ps`` behind ``fit_ps``, sharded checkpoints, the host
transport and the elastic recovery layer ``parallel.recovery``); the
flagship, serve, fleet, tenants, stream and ps benches (``python -m
dmlc_core_tpu_torch.bench [--serve | --fleet | --tenants | --stream |
--ps]``); and the one-hot product histogram spike
(``tools/spike_hist_floor.py``).
"""

from dmlc_core_tpu_torch.models.histgbt import HistGBT, HistGBTParam

__all__ = ["HistGBT", "HistGBTParam"]
__version__ = "0.1.0"
