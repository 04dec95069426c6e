"""Multi-tenant serving in the port (``serve/tenancy/*``, the frontend's
``tenants=`` seam) on the CPU.

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_tenancy.py``'s four classes, ``TestTenantRegistry``,
``TestTenantCheckpointRoundTrip``, ``TestTenantPolicy`` and
``TestZipfTenantSampler``, with nothing left out.

The port's own checks: tenant checkpoints cross-load between the two
packages both ways (the same bytes; a HistGBT's margins bit-identical,
GBLinear's within 1e-6, probabilities through a port registry within
rtol 1e-5, atol 1e-6), the registry's ``device`` reaches every
model a page-in rebuilds, and the frontend's ``tenants=`` seam serves a
port ``TenantRegistry`` over HTTP with the ``X-Dmlc-Tenant`` header,
paging tenants out and back in.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.models import GBLinear as JaxGBLinear  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.parallel.mesh import local_mesh  # noqa: E402
from dmlc_core_tpu.serve import tenancy as jax_tenancy  # noqa: E402
from dmlc_core_tpu_torch.models import GBLinear, HistGBT  # noqa: E402
from dmlc_core_tpu_torch.serve import (ModelRegistry,  # noqa: E402
                                       ResilientClient, ServeFrontend)
from dmlc_core_tpu_torch.serve.tenancy import (  # noqa: E402
    TenantRegistry, checkpoint_tenant_model, load_tenant_checkpoint)
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

_TEN = load_port("test_tenancy.py")
export(globals(), _TEN, ["TestTenantRegistry",
                         "TestTenantCheckpointRoundTrip", "TestTenantPolicy",
                         "TestZipfTenantSampler"])
# the loaded file's module-scoped data fixture
data = _TEN.data


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _data(n=300, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# tenant checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["histgbt", "gblinear"])
def test_tenant_checkpoint_cross_loads_both_ways(family, tmp_path):
    """A JAX ``checkpoint_tenant_model`` file loads in the port's
    ``load_tenant_checkpoint`` and predicts what JAX's model predicts, and
    the reverse; both packages write the same bytes for the same model.
    Margins: HistGBT bit for bit; GBLinear within rtol/atol 1e-6 (its
    dot product's sum order is each package's)."""
    X, y = _data()
    if family == "histgbt":
        jm = JaxHistGBT(n_trees=3, max_depth=3, n_bins=16,
                        mesh=local_mesh(1)).fit(X, y)
        tm = HistGBT(device="cpu", n_trees=3, max_depth=3,
                     n_bins=16).fit(X, y)
    else:
        jm = JaxGBLinear(n_rounds=5).fit(X, y)
        tm = GBLinear(device="cpu", n_rounds=5).fit(X, y)

    def same(a, b):
        if family == "histgbt":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

    # JAX writes, the port reads
    jax_uri = str(tmp_path / "jax.tckpt")
    jax_tenancy.checkpoint_tenant_model(jax_uri, "alpha", jm, version=4)
    tenant, version, back = load_tenant_checkpoint(jax_uri, device="cpu")
    assert (tenant, version) == ("alpha", 4)
    assert back.device.type == "cpu"
    same(back.predict(X, output_margin=True),
         np.asarray(jm.predict(X, output_margin=True)))
    # the port re-writes it: the same bytes
    port_uri = str(tmp_path / "port.tckpt")
    checkpoint_tenant_model(port_uri, "alpha", back, version=4)
    for suffix in ("", ".crc"):
        assert ((tmp_path / f"jax.tckpt{suffix}").read_bytes()
                == (tmp_path / f"port.tckpt{suffix}").read_bytes())
    # the port writes its own model, JAX reads
    own_uri = str(tmp_path / "own.tckpt")
    checkpoint_tenant_model(own_uri, "beta", tm, version=2)
    tenant, version, jback = jax_tenancy.load_tenant_checkpoint(own_uri)
    assert (tenant, version) == ("beta", 2)
    same(np.asarray(jback.predict(X, output_margin=True)),
         tm.predict(X, output_margin=True))
    # a JAX-written file through a port TenantRegistry.load: the
    # probabilities within the tolerance the serving registry is held to
    # (rtol 1e-5, atol 1e-6: each package's sigmoid may differ by an ulp)
    reg = TenantRegistry(device="cpu", max_batch=64, min_bucket=8)
    assert reg.load("alpha", jax_uri) == 4
    _, runner = reg.current("alpha")
    np.testing.assert_allclose(runner.predict(X[:37]),
                               np.asarray(jm.predict(X[:37])),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(runner.predict(X[:37]),
                                  back.predict(X[:37]))


def test_registry_device_reaches_every_page_in():
    X, y = _data()
    reg = TenantRegistry(resident_cap=1, device="cpu", max_batch=16,
                         min_bucket=4)
    assert reg.device == "cpu"
    reg.publish("a", HistGBT(device="cpu", n_trees=2, max_depth=3,
                             n_bins=16).fit(X, y))
    reg.publish("b", HistGBT(device="cpu", n_trees=3, max_depth=2,
                             n_bins=16).fit(X, 1.0 - y))
    assert reg.resident() == ["b"]
    _, r = reg.current("a")                     # page-in: warmed ladder
    assert r.model.device.type == "cpu"
    assert sorted(r.compiled_shapes) == [4, 8, 16]
    assert reg.restores == 1 and reg.evictions == 2


def test_frontend_tenants_seam_pages_over_http():
    """The frontend's ``tenants=`` seam: predicts with the
    ``X-Dmlc-Tenant`` header run on that tenant's runner, bit-identical
    to its model's ``predict``; with a cap of 2 over 4 tenants the
    registry evicts and restores, and a restored tenant answers as
    before; an unknown tenant is a 404."""
    X, y = _data(400)
    models = {f"t{i}": HistGBT(device="cpu", n_trees=2 + i,
                               max_depth=2 + i % 2, n_bins=16).fit(
                                   X, (X[:, i] > 0).astype(np.float32))
              for i in range(4)}
    reg = TenantRegistry(resident_cap=2, device="cpu", max_batch=32,
                         min_bucket=8)
    for name, m in models.items():
        reg.publish(name, m)
    single = ModelRegistry(name="tenants-seam", device="cpu", max_batch=32)
    with ServeFrontend(single, max_batch=32, tenants=reg) as fe:
        client = ResilientClient(fe.url)
        rng = np.random.default_rng(5)
        first = {}
        for i in range(24):
            name = f"t{int(rng.integers(0, 4))}"
            lo, k = int(rng.integers(0, 380)), int(rng.integers(1, 20))
            got, version = client.predict(X[lo:lo + k], tenant=name)
            assert version == 1
            np.testing.assert_array_equal(
                got, models[name].predict(X[lo:lo + k]))
            first.setdefault(name, client.predict(X[:16], tenant=name)[0])
        for name, want in first.items():
            np.testing.assert_array_equal(
                client.predict(X[:16], tenant=name)[0], want)
        assert reg.evictions > 0 and reg.restores > 0
        health = client.healthz()
        assert sorted(health["tenants"]) == ["t0", "t1", "t2", "t3"]
        with pytest.raises(Exception, match="404"):
            client.predict(X[:2], tenant="nobody")


# ---------------------------------------------------------------------------
# the port bench's --tenants
# ---------------------------------------------------------------------------

def test_bench_tenants_record():
    import json
    import subprocess

    env = dict(os.environ, BENCH_FORCE_CPU="1", TENANTS_SECONDS="2",
               TENANTS_TRAIN_ROWS="2000", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.bench",
                          "--tenants"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    assert [r["phase"] for r in lines] == ["train", "load", "done"]
    rec = lines[-1]
    assert rec["metric"] == "tenant_requests_per_sec"
    assert rec["provisional"] is False and rec["platform"] == "cpu"
    assert rec["requests"] > 0 and rec["wrong"] == 0 and rec["value"] > 0
    assert rec["evictions"] > 0 and rec["warm_restores"] > 0
    assert len(rec["resident"]) <= rec["resident_cap"] == 4
    assert sorted(rec["by_tenant"]) == [f"t{i:02d}" for i in range(12)]
    assert rec["page_in_seconds_mean"] > 0
    for k in ("tenants", "zipf_a", "duration_s", "threads", "elapsed_s"):
        assert k in rec, k


def test_serve_threads_probe_runs_a_cpu_variant(tmp_path):
    # the probe of serving from several threads of one process
    # (tools/serve_threads.py): one CPU variant end to end
    from dmlc_core_tpu_torch.tools import serve_threads

    res = serve_threads.run_variant("cpu_t4", 1.0, str(tmp_path))
    assert res["threads"] == 4 and res["cpu"] is True
    assert res["value"] > 0 and res["requests"] > 0 and res["wrong"] == 0
    (probe,) = res["probe"]
    for k in ("voluntary_switches_per_request", "cpu_seconds_per_request",
              "lag_p50_ms", "lag_p99_ms"):
        assert probe[k] >= 0, k
