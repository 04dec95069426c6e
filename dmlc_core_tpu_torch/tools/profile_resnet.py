"""Where a ResNet train step's time goes on the card.

    python -m dmlc_core_tpu_torch.tools.profile_resnet [--out PATH]

ResNet-50 at 224², batch 256, bf16 (``RESNET_*`` as
``tools/bench_resnet_feed.py`` reads them) on resident data, seed 0:

* the step's time by CUDA events (median of ``--steps`` steps after 3
  warm ones), at PyTorch's defaults (cuDNN picks its convolution
  algorithms by heuristics);
* a ``utils/profiler.device_trace`` of ``--profile-steps`` steps: device
  time a step by kernel group — convolutions and their gradients,
  reductions, elementwise kernels, the rest — the top kernels, and the
  device's idle share of the unprofiled step's time.

One JSON line on stdout (also written to ``--out``); ``--device cpu``
with small ``RESNET_*`` sizes rehearses it (no device metric).
"""

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Any, Dict

_CONV = ("conv", "cudnn", "xmma", "implicit", "gemm", "dgrad", "wgrad",
         "fprop", "winograd", "fft")
_REDUCE = ("reduce", "welford")
_ELEMENTWISE = ("elementwise", "vectorized", "unrolled", "pointwise")


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in (("conv", _CONV), ("reduce", _REDUCE),
                        ("elementwise", _ELEMENTWISE)):
        if any(k in low for k in keys):
            return group
    return "other"


def _step_ms(torch, trainer, images, labels, steps: int) -> float:
    """Median ms of one step by CUDA events (wall time on the CPU)."""
    cuda = images.is_cuda
    times = []
    for _ in range(steps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(images, labels)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            trainer.train_step(images, labels)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device: Any = None, steps: int = 5, profile_steps: int = 3
        ) -> Dict[str, Any]:
    import numpy as np
    import torch

    from dmlc_core_tpu_torch.models.resnet import ResNetTrainer
    from dmlc_core_tpu_torch.utils import profiler
    from dmlc_core_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                  resolve_device)

    batch = int(os.environ.get("RESNET_BATCH", 256))
    hw = int(os.environ.get("RESNET_HW", 224))
    variant = os.environ.get("RESNET_VARIANT", "resnet50")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(
        0, 256, size=(batch, hw, hw, 3), dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(
        0, 1000, size=batch).astype(np.int64)).to(dev)
    out: Dict[str, Any] = {"metric": "resnet_step_profile",
                           "variant": variant, "batch": batch, "hw": hw,
                           "platform": "gpu" if cuda else "cpu"}
    tr = ResNetTrainer(variant=variant, num_classes=1000,
                       learning_rate=0.05, device=dev)
    tr.init((hw, hw, 3), seed=0)
    for _ in range(3):
        tr.train_step(images, labels)
    out["step_ms"] = round(_step_ms(torch, tr, images, labels, steps), 3)
    logdir = tempfile.mkdtemp(prefix="profile_resnet_")
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profiler.device_trace(logdir) as prof:
        for i in range(profile_steps):
            with profiler.step_annotation(i, name="resnet"):
                tr.train_step(images, labels)
        if cuda:
            torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / profile_steps
    out["profile"] = None
    if prof is not None:
        kernels: Dict[str, float] = {}
        for ev in prof.key_averages():
            if (ev.device_type != torch.autograd.DeviceType.CUDA
                    or ev.key.startswith("resnet#")):
                continue    # host ops (their kernels count), step ranges
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us
        groups: Dict[str, float] = {}
        for name, us in kernels.items():
            groups[_group(name)] = groups.get(_group(name), 0.0) + us
        device_ms = sum(kernels.values()) / 1e3 / profile_steps
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        out["profile"] = {
            "steps": profile_steps,
            "wall_ms_per_step": round(wall_ms, 3),
            "device_ms_per_step": round(device_ms, 3),
            # against the unprofiled step's CUDA-event time: the
            # profiler's own cost stretches the traced steps' wall
            "idle_share": (round(1.0 - device_ms / out["step_ms"], 4)
                           if cuda else None),
            "device_ms_by_group": {g: round(us / 1e3 / profile_steps, 3)
                                   for g, us in sorted(groups.items())},
            "top_kernels_ms": [[n[:120], round(us / 1e3 / profile_steps, 3)]
                               for n, us in top],
            "trace": os.path.join(logdir, "trace.json"),
        }
    if cuda:
        out["device_kind"] = torch.cuda.get_device_name(dev)
        out["nvidia_smi"] = gpu_name_and_power_limit()
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rec = run(args.device, args.steps, args.profile_steps)
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
