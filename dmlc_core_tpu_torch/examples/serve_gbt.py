"""Serve a hist-GBT model over HTTP: train → checkpoint → registry load →
query → hot swap to v2 with zero downtime.

    python -m dmlc_core_tpu_torch.examples.serve_gbt [--device cpu] [--smoke]

The port of ``examples/serve_gbt.py``: two generations (20 and 60 trees
of depth 5 over 64 bins on 100,000 HIGGS-like rows) checkpointed with
monotone versions, a ``ModelRegistry`` on the device behind a
``ServeFrontend`` on an ephemeral localhost port, a hot swap, and the
``/healthz`` and ``/metrics`` endpoints.  ``--smoke`` fits 5,000 rows and
4 and 8 trees.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import urllib.request

import numpy as np

from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import HistGBT
from dmlc_core_tpu_torch.serve import (ModelRegistry, ServeFrontend,
                                       checkpoint_model)


def make_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    margin = X[:, 0] * X[:, 1] + 0.5 * X[:, 2] - 0.8 * X[:, 3] * (X[:, 4] > 0)
    return X, (margin > 0).astype(np.float32)


def post_predict(url, rows):
    body = json.dumps({"rows": np.asarray(rows).tolist()}).encode()
    req = urllib.request.Request(
        url + "/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    n, generations = ((5_000, ((1, 4), (2, 8))) if args.smoke
                      else (100_000, ((1, 20), (2, 60))))
    X, y = make_data(n, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        # two model generations, checkpointed with monotone versions (any
        # Stream URI works: file://, mem://, object stores)
        ck = os.path.join(tmp, "serve_gbt_example")
        direct = {}
        for version, n_trees in generations:
            model = HistGBT(device=args.device, n_trees=n_trees,
                            max_depth=5, n_bins=64, learning_rate=0.3)
            model.fit(X, y)
            checkpoint_model(f"{ck}.v{version}", model, version=version)
            direct[version] = model.predict(X[:5])
            print(f"checkpointed v{version}: {n_trees} trees")

        registry = ModelRegistry(device=args.device, max_batch=256,
                                 min_bucket=8)
        registry.load(f"{ck}.v1")
        with ServeFrontend(registry, max_batch=256, max_delay=0.002) as fe:
            print(f"serving on {fe.url}")
            resp = post_predict(fe.url, X[:5])
            print(f"v{resp['version']} predictions: "
                  f"{np.round(resp['predictions'], 4)}")
            assert resp["version"] == 1 and np.array_equal(
                np.asarray(resp["predictions"], np.float32), direct[1])

            # hot swap: in-flight batches finish on v1, new ones see v2
            registry.load(f"{ck}.v2")
            resp = post_predict(fe.url, X[:5])
            print(f"after hot-swap, v{resp['version']} predictions: "
                  f"{np.round(resp['predictions'], 4)}")
            assert resp["version"] == 2 and np.array_equal(
                np.asarray(resp["predictions"], np.float32), direct[2])

            print(f"healthz: {json.loads(get(fe.url + '/healthz'))}")
            print("sample /metrics lines:")
            for line in get(fe.url + "/metrics").splitlines():
                if line.startswith(("dmlc_serve_batch_rows_count",
                                    "dmlc_serve_version_requests_total")):
                    print(" ", line)
    print("served v1, hot-swapped to v2: every answer the model's own")


if __name__ == "__main__":
    sys.exit(main())
