"""A factorization machine on a ``.libfm`` file (the LibFM parser's
consumer).

    python -m dmlc_core_tpu_torch.examples.fm_libfm [--device cpu] [--smoke]

The port of ``examples/fm_libfm.py``: 20,000 rows of 10 fields in LibFM
format (``label field:index:value ...``) with a purely pairwise signal
that no linear model fits, a second-order FM (8 factors, 20 epochs, Adam
at 0.1, batches of 4,096) trained through ``RowBlockIter`` pages.
``--smoke`` writes 2,000 rows and runs 3 epochs.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from dmlc_core_tpu_torch.data.iter import RowBlockIter
from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import FM


def write_libfm(path, n=20_000, F=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    # purely pairwise signal: a linear model cannot fit this
    y = (1.5 * X[:, 0] * X[:, 1] - 2.0 * X[:, 2] * X[:, 3] > 0)
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{j % 4}:{j}:{X[i, j]:.6f}" for j in range(F))
            f.write(f"{int(y[i])} {feats}\n")
    return X, y.astype(np.float32)


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    n, epochs = (2_000, 3) if args.smoke else (20_000, 20)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "train.libfm")
        X, y = write_libfm(path, n=n)
        model = FM(device=args.device, n_factors=8, n_epochs=epochs,
                   learning_rate=0.1, batch_size=4096)
        it = RowBlockIter.create(path, 0, 1, "libfm")
        model.fit_iter(it)
        it.close()
    acc = float(((model.predict(X) > 0.5) == (y > 0.5)).mean())
    print(f"train accuracy {acc:.3f} in {model.last_fit_seconds:.1f}s "
          f"({model.param.n_epochs} epochs)")


if __name__ == "__main__":
    sys.exit(main())
