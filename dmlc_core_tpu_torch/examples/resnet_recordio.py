"""RecordIO → ResNet training pipeline (BASELINE configuration 2's shape).

    python -m dmlc_core_tpu_torch.examples.resnet_recordio [--device cpu] [--smoke]

The port of ``examples/resnet_recordio.py``: a small synthetic image set
(2 shards × 256 records, 32×32×3, 10 classes whose channel-0 brightness
tracks the label) written as sharded RecordIO files (the MXNet ``.rec``
wire format), then ``ResNetTrainer`` (ResNet-18) over them through the
data plane — sharded ``InputSplit`` → record unpack → ``DeviceFeed``
double-buffered infeed → train steps — for 3 epochs of batches of 64,
reporting throughput and the infeed stall fraction.  ``--smoke`` writes
2 × 8 records and runs 1 epoch of batches of 8.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from dmlc_core_tpu_torch.data.image_record import pack_image_record
from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.io.recordio import RecordIOWriter
from dmlc_core_tpu_torch.models import ResNetTrainer


def write_shards(root, n_shards=2, per_shard=256, hw=32):
    rng = np.random.default_rng(0)
    for s in range(n_shards):
        with RecordIOWriter(os.path.join(root, f"part-{s}.rec")) as w:
            for _ in range(per_shard):
                label = int(rng.integers(0, 10))
                img = (rng.random((hw, hw, 3)) * 255).astype(np.uint8)
                # class signal: channel 0 brightness tracks the label
                img[..., 0] = np.clip(
                    img[..., 0].astype(np.int32) // 4 + label * 25,
                    0, 255).astype(np.uint8)
                w.write_record(pack_image_record(img, label))


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    per_shard, batch, epochs = (8, 8, 1) if args.smoke else (256, 64, 3)
    with tempfile.TemporaryDirectory() as root:
        write_shards(root, per_shard=per_shard)
        trainer = ResNetTrainer(variant="resnet18", num_classes=10,
                                learning_rate=0.05, device=args.device)
        stats = trainer.fit_from_records(
            os.path.join(root, "part-*.rec"),
            batch_size=batch, image_shape=(32, 32, 3), epochs=epochs,
            log_every=8)
    assert stats["steps"] > 0 and np.isfinite(stats["last_loss"]), stats
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in stats.items()})


if __name__ == "__main__":
    sys.exit(main())
