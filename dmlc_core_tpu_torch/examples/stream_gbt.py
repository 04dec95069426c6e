"""One command from a live event stream to continuously updated, served
predictions: the closed train → serve loop.

    python -m dmlc_core_tpu_torch.examples.stream_gbt [--device cpu] [--smoke]

The port of ``examples/stream_gbt.py``.  A writer thread appends
synthetic events (with concept drift between phases) to a growing
RecordIO shard directory; a ``RecordIOTailer`` follows it with a
crash-safe cursor; an ``OnlineTrainer`` warm-start-boosts a ``HistGBT`` on
each fresh chunk of 768 events; a ``ModelPublisher`` snapshots,
eval-gates and activates every refresh into the serving
``ModelRegistry``; a ``ServeFrontend`` answers HTTP ``/predict`` on
whatever version is live.  Four phases, or three with ``--smoke``, which
also asserts at least 2 published versions and that the final registry
serves.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.io.recordio import encode_records
from dmlc_core_tpu_torch.models import HistGBT
from dmlc_core_tpu_torch.serve import ModelRegistry, ServeFrontend
from dmlc_core_tpu_torch.stream import (ModelPublisher, OnlineTrainer,
                                        RecordIOTailer, encode_dense_events)

N_FEATURES = 8


def make_events(rng, n, drift):
    X = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + (0.5 + drift) * X[:, 2]
         - drift * X[:, 3] > 0).astype(np.float32)
    return X, y


def post_predict(url, rows):
    body = json.dumps({"rows": np.asarray(rows).tolist()}).encode()
    req = urllib.request.Request(
        url + "/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    smoke = args.smoke
    chunk_rows = 768
    n_chunks = 3 if smoke else 4
    total_events = chunk_rows * n_chunks
    rng = np.random.default_rng(7)

    root = tempfile.mkdtemp(prefix="stream_gbt_")
    shard_dir = os.path.join(root, "events")
    os.makedirs(shard_dir)
    appended = [0]

    def writer():
        """Append events in bursts, one shard file per drift phase: the
        tailer picks new shards up as they appear."""
        for phase in range(n_chunks):
            X, y = make_events(rng, chunk_rows, drift=0.2 * phase)
            with open(os.path.join(shard_dir, f"part-{phase:03d}.rec"),
                      "ab") as f:
                for lo in range(0, chunk_rows, 256):
                    f.write(encode_records(
                        encode_dense_events(X[lo:lo + 256],
                                            y[lo:lo + 256])))
                    f.flush()
                    appended[0] += min(256, chunk_rows - lo)
                    time.sleep(0.02)

    Xh, yh = make_events(np.random.default_rng(99), 2048, drift=0.0)
    registry = ModelRegistry(device=args.device, max_batch=256, min_bucket=8)
    publisher = ModelPublisher(
        registry, holdout=(Xh, yh),
        checkpoint_uri=os.path.join(root, "model.ckpt"), name="example")
    model = HistGBT(device=args.device, n_trees=4, max_depth=3, n_bins=16,
                    learning_rate=0.3)
    tailer = RecordIOTailer(shard_dir,
                            cursor_uri=os.path.join(root, "cursor.ckpt"),
                            name="example")
    trainer = OnlineTrainer(model, tailer, n_features=N_FEATURES,
                            chunk_rows=chunk_rows, window_chunks=2,
                            decay=1.0, publisher=publisher, name="example")

    t_writer = threading.Thread(target=writer, daemon=True)
    t_writer.start()

    with ServeFrontend(registry, max_batch=256, max_delay=0.002) as fe:
        print(f"serving on {fe.url}; tailing {shard_dir}")
        probe = Xh[:4]
        t_end = time.time() + 240
        while tailer.records_seen < total_events and time.time() < t_end:
            r = trainer.refresh(timeout=10.0)
            if r is None:
                if not t_writer.is_alive() \
                        and tailer.records_seen >= appended[0]:
                    break
                continue
            print(f"refresh {r['refresh']}: {r['rows']} fresh rows, "
                  f"{r['trees_total']} trees, v{r['version']} "
                  f"{'activated' if r['activated'] else 'ROLLED BACK'}"
                  f" (holdout score {r['score']:.4f})")
            resp = post_predict(fe.url, probe)
            print(f"  HTTP /predict → v{resp['version']}: "
                  f"{np.round(resp['predictions'], 3)}")
        t_writer.join(timeout=30)

        versions = registry.versions()
        resp = post_predict(fe.url, probe)
        print(f"final: {len(versions)} published versions "
              f"{versions}, serving v{resp['version']}, "
              f"{tailer.records_seen}/{appended[0]} events consumed, "
              f"{publisher.rollbacks} rollbacks")
        if smoke:
            assert len(versions) >= 2, \
                f"smoke: expected >= 2 published versions, got {versions}"
            assert resp["version"] == registry.current_version(), \
                "smoke: frontend serves a version the registry disowns"
            assert len(resp["predictions"]) == len(probe), \
                "smoke: final registry does not serve predictions"
            print("SMOKE OK")
    tailer.close()
    shutil.rmtree(root, ignore_errors=True)
    print(f"stream → train → serve loop done: {len(versions)} versions")


if __name__ == "__main__":
    sys.exit(main())
