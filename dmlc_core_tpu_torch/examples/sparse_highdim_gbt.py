"""High-dimensional sparse boosting: LibSVM → CSR → ``SparseHistGBT``.

    python -m dmlc_core_tpu_torch.examples.sparse_highdim_gbt [--device cpu] [--smoke]

The port of ``examples/sparse_highdim_gbt.py``: the workload the LibSVM
format exists for — hashed one-hot features (F = 50,000, about 30
present a row, power-law popularity), where a dense ``[n, F]`` bin matrix
is out of the question and absent entries carry meaning.  8,000 rows
through the data plane, 20 trees of depth 4 over 32 ragged bins, train
accuracy above 0.9, and a save/load round trip with equal margins.
``--smoke`` writes 2,000 rows and fits 10 trees.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from dmlc_core_tpu_torch.data.iter import RowBlockIter
from dmlc_core_tpu_torch.examples import _cli
from dmlc_core_tpu_torch.models import SparseHistGBT

F, PER_ROW = 50_000, 30


def write_svm(path, n):
    rng = np.random.default_rng(0)
    # power-law feature popularity; features 0/1 carry the label
    pop = 1.0 / np.arange(1, F + 1) ** 0.7
    pop /= pop.sum()
    rows = []
    y = np.empty(n, np.int32)
    for i in range(n):
        cols = np.unique(np.concatenate(
            [[0, 1], rng.choice(F, size=PER_ROW, p=pop)]))
        vals = rng.normal(size=len(cols)).astype(np.float32)
        y[i] = int(vals[cols == 0][0] + 0.5 * vals[cols == 1][0] > 0)
        rows.append((cols, vals))
    with open(path, "w") as f:
        for i, (cols, vals) in enumerate(rows):
            feats = " ".join(f"{c}:{v:.4f}" for c, v in zip(cols, vals))
            f.write(f"{y[i]} {feats}\n")


def main(argv=None):
    args = _cli.parse(__doc__, argv)
    n, trees = (2_000, 10) if args.smoke else (8_000, 20)
    with tempfile.TemporaryDirectory() as tmp:
        svm = os.path.join(tmp, "train.svm")
        write_svm(svm, n)
        # parse through the data plane, then hand the CSR arrays to the
        # sparse engine (concatenated over the pages)
        blocks = list(RowBlockIter.create(svm, 0, 1, "libsvm"))
        offset = np.concatenate(
            [[0]] + [np.diff(b.offset) for b in blocks]).cumsum()
        index = np.concatenate([b.index for b in blocks])
        value = np.concatenate(
            [b.value if b.value is not None
             else np.ones(len(b.index), np.float32) for b in blocks])
        label = np.concatenate([b.label for b in blocks])

        model = SparseHistGBT(device=args.device, n_trees=trees,
                              max_depth=4, n_bins=32, learning_rate=0.4)
        model.fit(offset, index, value, label, n_features=F)
        pred = model.predict(offset, index, value)
        acc = ((pred > 0.5) == label).mean()
        print(f"F={F}: {model.cuts.total_bins} ragged bins "
              f"(dense would need {F * 32}), train acc {acc:.3f}")
        assert acc > 0.9

        uri = os.path.join(tmp, "sparse_model.bin")
        model.save_model(uri)
        again = SparseHistGBT.load_model(uri, device=args.device)
        np.testing.assert_array_equal(
            again.predict(offset, index, value, output_margin=True),
            model.predict(offset, index, value, output_margin=True))
    print("save/load round trip OK")


if __name__ == "__main__":
    sys.exit(main())
