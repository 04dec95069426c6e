"""The port's examples (``dmlc_core_tpu_torch/examples``) on the CPU.

* every example runs as ``python -m dmlc_core_tpu_torch.examples.<name>
  --smoke --device cpu`` and exits 0 with its closing line;
* without a GPU an example asked for the card (its default) exits
  non-zero with the device error: no fallback to the CPU;
* the runner (``python -m dmlc_core_tpu_torch.examples``) passes
  ``--device`` and ``--smoke`` through, prints its JSON summary, and exits
  non-zero with the child's tail when an example fails;
* the four ``HistGBT`` examples (train_gbt, rank_pairwise,
  sklearn_pipeline, external_memory_gbt): the same seeded data and
  parameters through the JAX package's estimators, the fits held at
  parity level (b) (``tests/_torch_parity.py``), and at level (c) — the
  port's file loads in ``dmlc_core_tpu.models.HistGBT.load_model`` and
  predicts what the port predicts.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_parity import assert_level_b, assert_level_b_through  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch.examples import (  # noqa: E402
    external_memory_gbt, rank_pairwise, sklearn_pipeline, train_gbt)
from dmlc_core_tpu_torch.models import HistGBT  # noqa: E402

torch.set_num_threads(2)

#: each example's closing line under ``--smoke``
CLOSING = {
    "distributed_local": "4 workers through dmlc-submit --cluster local: exit 0",
    "elastic_recovery": "recovered model == uninterrupted model, bit-exact",
    "external_memory_gbt": "streamed predictions over 3000 rows",
    "fm_libfm": "train accuracy",
    "rank_pairwise": "(chance pairwise accuracy = 0.5)",
    "resnet_recordio": "'infeed_stall_fraction'",
    "serve_gbt": "served v1, hot-swapped to v2",
    "sklearn_pipeline": "grid search best",
    "sparse_highdim_gbt": "save/load round trip OK",
    "stream_gbt": "stream → train → serve loop done",
    "train_gbt": "saved, reloaded, predictions identical",
}


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "BENCH_"))}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _run(args, timeout=240, **extra):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          env=_env(**extra), capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("name", sorted(CLOSING))
def test_example_runs_on_the_cpu(name):
    res = _run([f"dmlc_core_tpu_torch.examples.{name}", "--smoke",
                "--device", "cpu"])
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert CLOSING[name] in lines[-1], lines[-5:]


def test_an_example_asked_for_the_card_refuses_without_one():
    res = _run(["dmlc_core_tpu_torch.examples.train_gbt", "--smoke"],
               CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "no CUDA GPU" in res.stderr


def test_the_runner_passes_flags_and_reports_failures():
    res = _run(["dmlc_core_tpu_torch.examples", "--smoke", "--device", "cpu",
                "train_gbt", "fm_libfm"])
    assert res.returncode == 0, res.stdout[-3000:]
    summary = json.loads(res.stdout.splitlines()[-1])["examples"]
    assert [r["name"] for r in summary] == ["train_gbt", "fm_libfm"]
    assert all(r["rc"] == 0 for r in summary)
    assert CLOSING["train_gbt"] in summary[0]["last"]
    # the card asked for and absent: the child fails, the runner too
    res = _run(["dmlc_core_tpu_torch.examples", "--smoke", "train_gbt"],
               CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 1
    assert "EXAMPLE FAILED: train_gbt" in res.stdout
    assert "no CUDA GPU" in res.stdout
    assert json.loads(res.stdout.splitlines()[-1])["examples"][0]["rc"] != 0


def _level_c(tm, X, tmp_path):
    """The port's file in the JAX package predicts what the port does."""
    path = str(tmp_path / "port.model")
    tm.save_model(path)
    back = JaxHistGBT.load_model(path, mesh=local_mesh(1))
    np.testing.assert_array_equal(
        np.asarray(back.predict(X, output_margin=True)),
        tm.predict(X, output_margin=True))


def test_train_gbt_meets_level_b_and_c(tmp_path):
    X, y, Xv, yv, kw, fit_kw = train_gbt.setup(smoke=True)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y, **fit_kw)
    tm = HistGBT(device="cpu", **kw).fit(X, y, **fit_kw)
    assert tm.best_iteration == jm.best_iteration
    assert_level_b_through(jm, tm, X, y, Xv, **fit_kw)
    _level_c(tm, Xv, tmp_path)


def test_rank_pairwise_meets_level_b_and_c(tmp_path):
    X, y, qid, Xt, _, _, kw = rank_pairwise.setup(smoke=True)
    jm = JaxHistGBT(mesh=local_mesh(1), **kw).fit(X, y, qid=qid)
    tm = HistGBT(device="cpu", **kw).fit(X, y, qid=qid)
    # at this size one agreeing split's gain parts by rtol 1.3e-4, past
    # the fixed 1e-4: each package's gains are held to float64 sums of
    # its own f32 pairwise gradients by the proofs (ROADMAP C20).  A
    # rank:* fit cannot be continued (JAX's padded layout is per fit), so
    # where the fits part at a tie the trees are held up to it
    assert_level_b(jm, tm, Xt, X=X, y=y, qid=qid, fixed=False)
    _level_c(tm, Xt, tmp_path)


def test_sklearn_pipeline_meets_level_b_and_c(tmp_path):
    from dmlc_core_tpu.models import GBTClassifier as JaxClassifier
    from dmlc_core_tpu_torch.models import GBTClassifier

    X, y, _, n_fit, kw = sklearn_pipeline.setup(smoke=True)
    jc = JaxClassifier(booster="gbtree", **kw["classifier"])
    tc = GBTClassifier(booster="gbtree", device="cpu", **kw["classifier"])
    jc.fit(X[:n_fit], y[:n_fit])
    tc.fit(X[:n_fit], y[:n_fit])
    assert list(tc.classes_) == list(jc.classes_) == ["ham", "spam"]
    codes = (y[:n_fit] == "spam").astype(np.float32)
    parted = assert_level_b(jc.model, tc.model, X[n_fit:], X=X[:n_fit],
                            y=codes)[1]
    if parted is None:
        np.testing.assert_array_equal(tc.predict(X[n_fit:]),
                                      jc.predict(X[n_fit:]))
    _level_c(tc.model, X[n_fit:], tmp_path)


def test_external_memory_gbt_meets_level_b_and_c(tmp_path):
    from dmlc_core_tpu.data import RowBlockIter as JaxRowBlockIter

    tm, labels, acc = external_memory_gbt.fit(str(tmp_path), "cpu", True)
    assert acc > 0.6
    n, kw, fit_kw = external_memory_gbt.setup(smoke=True)
    svm = str(tmp_path / "train.svm")
    it = JaxRowBlockIter.create(f"{svm}#{tmp_path}/jax_cache.bin", 0, 1,
                                "libsvm")
    jm = JaxHistGBT(mesh=local_mesh(1), **kw)
    jm.fit_external(it, **fit_kw)
    it.close()
    np.testing.assert_array_equal(np.asarray(jm.cuts), tm.cuts.numpy())
    # the dense rows as both fits saw them: absent entries are 0
    rows = external_memory_gbt.F
    X = np.zeros((n, rows), np.float32)
    with open(svm) as f:
        for i, line in enumerate(f):
            for tok in line.split()[1:]:
                j, v = tok.split(":")
                X[i, int(j)] = np.float32(v)
    # as in rank_pairwise (ROADMAP C20): the float64 proofs hold the gains
    assert_level_b(jm, tm, X, X=X, y=labels.astype(np.float32), fixed=False)
    _level_c(tm, X, tmp_path)
