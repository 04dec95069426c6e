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
a ``torch.distributed`` group; and ``models.BERT`` masked-LM training on
one GPU with hand-written flash-attention kernels.
"""

from dmlc_core_tpu_torch.models.histgbt import HistGBT, HistGBTParam

__all__ = ["HistGBT", "HistGBTParam"]
__version__ = "0.1.0"
