"""Config 2 at its written scale: 224×224×3 records → ResNet-50 feed.

    python -m dmlc_core_tpu_torch.tools.bench_resnet_feed

The port of ``scripts/bench_resnet_feed.py``: BASELINE config 2 names an
ImageNet-shard-scale pipeline (sharded RecordIO → DeviceFeed → a
ResNet-50-class consumer at batch 256).  The run writes synthetic image
shards (``RESNET_RECORDS`` records in 4 shards, labels recoverable from
the first channel, seed 0) and measures four legs, each with its basis:

1. ``host_pipeline_records_per_sec`` — the data plane alone (RecordIO read
   → record unpack → batch assembly), on the host;
2. ``device_step_seconds`` / ``device_records_per_sec`` — the train step
   at ``RESNET_BATCH`` on resident data (``torch.cuda.synchronize`` after
   the timed steps), beside ``est_tflop_per_step`` (counted from the
   model's own convolutions and head by :func:`train_step_flops`: 6.22
   TFLOP for ResNet-50 at 224², batch 256 — the JAX script's 3.1 TFLOP
   counted its 4.1 G multiply-adds an image as operations), the achieved
   rate and the least time the card could take at 989 TFLOP/s of bf16
   (``bound_step_ms``), and the peak device memory;
3. ``h2d_mbps`` — one batch's host→device copy from pageable memory;
4. ``e2e_*`` — the end-to-end run through ``DeviceFeed`` (pinned copies on
   a side stream) with its stall fraction; ``feed_keeps_up`` is
   ``host_pipeline ≥ device rate``.

Env knobs (the JAX script's): ``RESNET_RECORDS`` (1536), ``RESNET_BATCH``
(256), ``RESNET_STEPS`` (8), ``RESNET_HW`` (224), ``RESNET_VARIANT``
(resnet50); ``BENCH_CPU=1`` runs on the CPU (a rehearsal whose times are
no device metric).  Without it the run needs a CUDA card.  One JSON line
on stdout; :func:`run` returns the same record.
"""

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np

#: bf16 dense tensor-core peak of one H100 SXM (NVIDIA's data sheet)
_H100_BF16_FLOPS = 989e12


def write_shards(root: str, n_records: int, hw: int, n_shards: int = 4
                 ) -> int:
    """The JAX script's synthetic shards, record for record."""
    from dmlc_core_tpu_torch.data.image_record import pack_image_record
    from dmlc_core_tpu_torch.io.recordio import RecordIOWriter

    rng = np.random.default_rng(0)
    per = n_records // n_shards
    for s in range(n_shards):
        with RecordIOWriter(os.path.join(root, f"part-{s}.rec")) as w:
            for _ in range(per):
                label = int(rng.integers(0, 1000))
                img = rng.integers(0, 256, size=(hw, hw, 3),
                                   dtype=np.uint8)
                img[..., 0] = (img[..., 0] // 4
                               + (label % 10) * 25).astype(np.uint8)
                w.write_record(pack_image_record(img, label))
    return per * n_shards


def train_step_flops(model, image_shape, batch: int) -> int:
    """Operations of one train step at ``batch``, counted from the
    model's own layers: a convolution's forward is 2·Cin·Cout·kh·kw·Ho·Wo
    an image (a multiply and an add per weight tap), the head's 2·in·out;
    the backward is twice the forward (the input's and the weight's
    gradients), less the stem's input gradient, which nothing needs.
    BN, ReLU, pooling and the loss are left out: they move bytes, with
    few operations.  The output sizes come from one forward of a zero
    image."""
    import torch

    counts = []

    def hook(mod, inputs, out):
        w = mod.weight
        per_out = w[0].numel() if w.dim() == 4 else w.shape[1]
        counts.append(2 * per_out * out[0].numel())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Linear)
             or type(m).__name__ == "Conv"]
    try:
        dev = next(model.parameters()).device
        with torch.no_grad():
            model(torch.zeros((1, *image_shape), dtype=torch.uint8,
                              device=dev), train=False)
    finally:
        for h in hooks:
            h.remove()
    stem = counts[0]                      # the first layer run
    return batch * (3 * sum(counts) - stem)


def run(device: Optional[str] = None) -> Dict[str, Any]:
    """All four legs; ``device`` None means ``cuda`` (``"cpu"`` when
    ``BENCH_CPU`` is set)."""
    import torch

    from dmlc_core_tpu_torch.data.image_record import batch_iterator
    from dmlc_core_tpu_torch.models.resnet import ResNetTrainer
    from dmlc_core_tpu_torch.utils.device import (gpu_name_and_power_limit,
                                                  resolve_device)

    n_records = int(os.environ.get("RESNET_RECORDS", 1536))
    batch = int(os.environ.get("RESNET_BATCH", 256))
    steps = int(os.environ.get("RESNET_STEPS", 8))
    hw = int(os.environ.get("RESNET_HW", 224))
    variant = os.environ.get("RESNET_VARIANT", "resnet50")
    if device is None and os.environ.get("BENCH_CPU"):
        device = "cpu"
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    root = tempfile.mkdtemp(prefix="resnet_feed_")
    try:
        t0 = time.perf_counter()
        total = write_shards(root, n_records, hw)
        write_s = time.perf_counter() - t0
        uri = os.path.join(root, "part-*.rec")

        # 1. host pipeline alone (the config-2 claim's own leg)
        t0 = time.perf_counter()
        host_recs = 0
        for _images, labels in batch_iterator(uri, 0, 1, batch,
                                              (hw, hw, 3)):
            host_recs += len(labels)
        host_s = time.perf_counter() - t0
        host_rate = host_recs / host_s

        # 2. device step on resident data (the consumption ceiling)
        trainer = ResNetTrainer(variant=variant, num_classes=1000,
                                learning_rate=0.05, device=dev)
        trainer.init((hw, hw, 3))
        rng = np.random.default_rng(1)
        imgs = rng.integers(0, 256, size=(batch, hw, hw, 3), dtype=np.uint8)
        lbls = rng.integers(0, 1000, size=batch).astype(np.int32)
        di = torch.from_numpy(imgs).to(dev)
        dl = torch.from_numpy(lbls).to(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, acc = trainer.train_step(di, dl)            # first step
        first_loss = float(loss)
        first_s = time.perf_counter() - t0
        losses = [first_loss]
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, acc = trainer.train_step(di, dl)
        sync()
        step_s = (time.perf_counter() - t0) / steps
        losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        device_rate = batch / step_s
        flop_step = train_step_flops(trainer.model, (hw, hw, 3), batch)

        # 3. one batch's host->device copy (pageable memory)
        h2d_mbps = None
        if cuda:
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                torch.from_numpy(imgs).to(dev)
            sync()
            h2d_mbps = 3 * imgs.nbytes / (time.perf_counter() - t0) / 1e6
        del di, dl

        # 4. end to end through DeviceFeed
        e2e = trainer.fit_from_records(uri, batch_size=batch,
                                       image_shape=(hw, hw, 3), epochs=1)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    out = {
        "metric": "resnet_feed_224",
        "records": total, "batch": batch, "hw": hw, "variant": variant,
        "dtype": str(trainer.dtype).replace("torch.", ""),
        "write_seconds": round(write_s, 2),
        "host_pipeline_records_per_sec": round(host_rate, 1),
        "host_pipeline_mbps": round(host_rate * hw * hw * 3 / 1e6, 1),
        "first_step_seconds": round(first_s, 3),
        "device_step_seconds": round(step_s, 5),
        "device_records_per_sec": round(device_rate, 1),
        "est_tflop_per_step": round(flop_step / 1e12, 4),
        "achieved_tflops": (round(flop_step / step_s / 1e12, 1)
                            if cuda else None),
        "bound_step_ms": round(flop_step / _H100_BF16_FLOPS * 1e3, 3),
        "peak_mem_bytes": peak,
        "losses": [round(v, 4) for v in losses],
        "h2d_mbps": round(h2d_mbps, 1) if h2d_mbps else None,
        "e2e_steps": e2e["steps"],
        "e2e_records_per_sec": round(e2e["records_per_sec"], 1),
        "e2e_stall_fraction": round(e2e["infeed_stall_fraction"], 4),
        "e2e_last_loss": round(e2e["last_loss"], 4),
        "e2e_basis": "DeviceFeed over the host's own PCIe: pinned copies "
                     "on a side stream, depth 2; the stall is the time "
                     "the step waited on the host pipeline",
        "feed_keeps_up": bool(host_rate >= device_rate),
        "platform": "gpu" if cuda else "cpu",
    }
    if cuda:
        out["device_kind"] = torch.cuda.get_device_name(dev)
        out["nvidia_smi"] = gpu_name_and_power_limit()
    return out


def main() -> None:
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
