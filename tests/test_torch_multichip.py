"""The port's multi-card parity drill (``python -m
dmlc_core_tpu_torch.tools.check_multichip``) on gloo ranks of the CPU.

* at ``MULTICHIP_DEVICES`` 2 and 4 it exits 0 with its three parities
  true, and its report carries every key of the JAX script's report
  (``scripts/check_multichip.py``, run as a subprocess at the same count);
* the check's one-process fit meets parity level (b)
  (``tests/_torch_parity.py``) against the JAX package's one-device fit
  of the same rows and cuts;
* a one-bit difference in one rank's cuts fails contract 1, so the check
  can fail.

Contract 3 is ``make_device_data_iter`` on several ranks: each rank
streams its own rows with the cuts given.
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

from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.ops.quantile import compute_cuts as jax_cuts  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu_torch.models import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.tools import check_multichip as mc  # noqa: E402
from _torch_parity import assert_level_b  # noqa: E402

# a few intra-op threads per test process: the suite runs several
# processes on the host's cores
torch.set_num_threads(2)


def _env(n):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MULTICHIP_", "DMLC_"))}
    env["MULTICHIP_DEVICES"] = str(n)
    return env


def _jax_report(n, tmp_path):
    out = tmp_path / "jax.json"
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "check_multichip.py"),
         "--out", str(out)], cwd=ROOT, env=_env(n), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("n", [2, 4])
def test_check_multichip_on_cpu_ranks(n, tmp_path):
    out = tmp_path / "port.json"
    res = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools.check_multichip",
         "--device", "cpu", "--out", str(out)], cwd=ROOT, env=_env(n),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "multichip parity OK" in res.stdout
    port = json.loads(out.read_text())
    assert json.loads(res.stdout.splitlines()[-2]) == port
    want = _jax_report(n, tmp_path)
    assert set(want) <= set(port), set(want) - set(port)
    assert set(want["parity"]) == set(port["parity"])
    assert all(port["parity"].values()), port["parity"]
    assert port["cut_bytes_equal_across_ranks"] is True
    for k in ("check", "n_devices", "rows", "features", "rounds",
              "hist_psum_bytes_per_round"):
        assert port[k] == want[k], k
    assert port["deterministic_hist_blocks"] is None
    assert set(port["rounds_per_sec_per_chip"]) == {"1", str(n)}
    assert port["scaling_efficiency_cpu"] > 0
    assert port["rank_devices"] == ["cpu"] * n


def test_one_rank_fit_is_level_b_against_jax():
    X, y, cuts = mc.check_rows()
    jcuts = np.asarray(jax_cuts(X, mc.N_BINS))
    np.testing.assert_array_equal(cuts, jcuts)
    tm = HistGBT(device="cpu", **mc.KW).fit(X, y, cuts=cuts)
    jm = JaxHistGBT(mesh=local_mesh(1), **mc.KW).fit(X, y, cuts=jcuts)
    Xv = np.random.default_rng(8).normal(
        size=(2000, mc.FEATURES)).astype(np.float32)
    # one agreeing node's gain parts by rtol 1.3e-4 in tree 2, past the
    # fixed 1e-4: JAX's f32 sums over 10,007 rows (ROADMAP C20); the
    # float64 proofs hold every node of both fits
    assert_level_b(jm, tm, Xv, X=X, y=y, fixed=False)


def test_a_one_bit_cut_difference_fails_contract_1():
    _, _, cuts = mc.check_rows()
    planted = cuts.copy()
    planted.view(np.uint32)[3, 7] ^= 1           # one bit of one cut
    threads = torch.get_num_threads()
    report, failures = mc.run(2, "cpu", rank_cuts={1: planted})
    assert torch.get_num_threads() == threads
    assert report["cut_bytes_equal_across_ranks"] is False
    assert report["parity"]["ensemble_bytes_equal_1_vs_n"] is False
    assert "a rank's cut bytes differ from the oracle's" in failures


def test_cpu_only_run_refuses_the_card_forms(monkeypatch):
    from dmlc_core_tpu_torch.base.logging import Error

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(Error, match="no CUDA GPU"):
            mc._placement(device, 2)
    assert mc._placement("cpu", 8) == ("cpu", "cpu", "gloo")
