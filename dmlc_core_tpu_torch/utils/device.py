"""Device selection for the PyTorch port.

The counterpart of ``dmlc_core_tpu.utils.platform``: where the JAX package
forces its platform through ``jax.config``, this package takes an explicit
``device`` argument.  Entry points run on ``cuda`` unless the caller asks
for the CPU; a missing GPU is an error, never a quiet fall back to the CPU.
The hand-written kernels are compiled for Hopper (``sm_90a``), so a CUDA
device must report compute capability 9.0.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

from dmlc_core_tpu_torch.base.logging import CHECK, log_fatal

__all__ = ["resolve_device", "gpu_name_and_power_limit"]

#: compute capability the CUDA kernels are built for (sm_90a)
HOPPER = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``: ``None`` means ``cuda``.

    Raises :class:`~dmlc_core_tpu_torch.base.logging.Error` when a CUDA
    device is asked for (explicitly or by default) and none is present,
    or when it is not a Hopper card.  Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    CHECK(dev.type == "cuda", f"unsupported device {dev} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        log_fatal(f"device {dev}: no CUDA GPU is available — pass "
                  "device='cpu' to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    CHECK(cap == HOPPER,
          f"device {dev} ({torch.cuda.get_device_name(dev)}) has compute "
          f"capability {cap}; the kernels are built for sm_90a (Hopper)")
    return dev


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the label every measurement is recorded beside)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
