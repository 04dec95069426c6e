"""The port's cold start on the CPU: the kernels' build handle parked on
every fit (``DMLC_COLDSTART_OVERLAP``, ``DMLC_WARMUP_EXEC``), chunked
in-core ingest (``DMLC_INGEST_CHUNK_ROWS``), the external engine's phase
timings (``DMLC_METRICS_GBT_PHASES``) and the base API they stand on
(``Parameter``'s JSON, ``block_until_ready_time``).

The JAX package's own tests are loaded against the port (``*_port``):
``tests/test_compile_cache.py``'s ``TestOverlapParity``,
``TestStreamedIngest``, ``TestColdStartEvidence`` and
``TestServePrewarm``, whole.  ``TestCompileCache`` has no counterpart:
the port compiles no XLA program, and its builds go through
``ops/_build.py``'s hashed cache (ROADMAP A).  On the CPU there is
nothing to build, so the handle parks and is matched as JAX's is, and
``last_compile_seconds`` stays None.

The port's own checks: a ``Parameter`` JSON written by either package
loads in the other, with JAX's hash equality; chunked bins are
``torch.equal`` to the whole matrix's at several slab sizes, in missing
mode, against the JAX package's bins, and on 2 gloo ranks; overlap on
and off write one model file; the phase timings of ``fit_external``'s
chunked route observe every phase and change no byte.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dmlc_core_tpu.base import parameter as jax_parameter  # noqa: E402
from dmlc_core_tpu.models import HistGBT as JaxHistGBT  # noqa: E402
from dmlc_core_tpu.models.histgbt import HistGBTParam as JaxParam  # noqa: E402
from dmlc_core_tpu_torch.base import metrics as _metrics  # noqa: E402
from dmlc_core_tpu_torch.base import parameter as port_parameter  # noqa: E402
from dmlc_core_tpu_torch.base.logging import Error  # noqa: E402
from dmlc_core_tpu_torch.base.timer import block_until_ready_time  # noqa: E402
from dmlc_core_tpu_torch.data.iter import ArrayRowIter  # noqa: E402
from dmlc_core_tpu_torch.io.memory_io import MemoryStringStream  # noqa: E402
from dmlc_core_tpu_torch.models import histgbt as port_histgbt  # noqa: E402
from dmlc_core_tpu_torch.models import HistGBT  # noqa: E402
from dmlc_core_tpu_torch.models.gbt_split import gbt_metrics  # noqa: E402
from dmlc_core_tpu_torch.models.histgbt import HistGBTParam  # noqa: E402
from dmlc_core_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from _torch_suites import export, load_port, on_cpu  # noqa: E402,F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CC = load_port("test_compile_cache.py", [
    ("from dmlc_core_tpu.base import compile_cache as cc\n", ""),
    ("from dmlc_core_tpu.models.histgbt import (_AOT_EXEC_CACHE,\n"
     "                                          _ROUND_FN_CACHE,\n"
     "                                          _rounds_schedule)\n",
     "from dmlc_core_tpu.models.histgbt import _rounds_schedule\n")])
export(globals(), _CC, ["TestOverlapParity", "TestStreamedIngest",
                        "TestColdStartEvidence", "TestServePrewarm"])


@pytest.fixture(autouse=True)
def _port_on_cpu(on_cpu):
    yield


def _data(n=500, F=6, seed=4, nan=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    if nan:
        X[rng.random(X.shape) < 0.1] = np.nan
    y = (np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) > 0
         ).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# Parameter: one JSON text and one hash in both packages
# ---------------------------------------------------------------------------

def _param_classes():
    def make(mod):
        class Shape(mod.Parameter):
            depth = mod.field(int, default=3, lower_bound=1,
                              description="tree depth")
            act = mod.field(str, default="relu", enum=["relu", "tanh"])
            dims = mod.field(list, default=())
            rate = mod.field(float, default=0.5)
        return Shape
    return make(jax_parameter), make(port_parameter)


def test_parameter_json_crosses_the_packages():
    JaxShape, PortShape = _param_classes()
    kw = {"depth": "7", "act": "tanh", "dims": "4, 8", "rate": "0.25"}
    j, t = JaxShape(**kw), PortShape(**kw)
    assert t.save_json() == j.save_json()
    j2, t2 = JaxShape(), PortShape()
    j2.load_json(t.save_json())
    t2.load_json(j.save_json())
    assert j2 == j and t2 == t
    # equal parameters hash alike, list fields included, as JAX's do
    assert hash(t2) == hash(t) == hash(j)
    assert PortShape.doc_string() == JaxShape.doc_string()
    # through a stream
    s = MemoryStringStream()
    t.save(s)
    s.seek(0)
    t3 = PortShape()
    t3.load(s)
    assert t3 == t


def test_histgbt_param_json_is_the_jax_packages():
    kw = dict(n_trees=7, max_depth=4, n_bins=64, learning_rate=0.2,
              subsample=0.8, monotone_constraints=[1, 0, -1])
    text = HistGBTParam(**kw).save_json()
    assert text == JaxParam(**kw).save_json()
    back = JaxParam()
    back.load_json(text)
    assert back == JaxParam(**kw)
    assert hash(HistGBTParam(**kw)) == hash(HistGBTParam(**kw))


def test_block_until_ready_time_passes_results_through():
    out, dt = block_until_ready_time(
        lambda a, b=1: {"x": [torch.ones(2) * a, (b, "s")]}, 3, b=4)
    assert dt >= 0.0 and out["x"][1] == (4, "s")
    assert torch.equal(out["x"][0], torch.full((2,), 3.0))


# ---------------------------------------------------------------------------
# chunked in-core ingest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing", [False, True], ids=["standard", "nan"])
@pytest.mark.parametrize("chunk", [1, 7, 96, 500])
def test_chunked_bins_equal_the_whole_matrix(monkeypatch, chunk, missing):
    X, y = _data(nan=missing)
    w = np.linspace(0.5, 1.5, len(y)).astype(np.float32)
    monkeypatch.setenv("DMLC_INGEST_CHUNK_ROWS", "0")
    whole = HistGBT(n_bins=16)
    dw = whole.make_device_data(X, y, weight=w)
    monkeypatch.setenv("DMLC_INGEST_CHUNK_ROWS", str(chunk))
    m = HistGBT(n_bins=16)
    dc = m.make_device_data(X, y, weight=w)
    assert m._missing == missing
    assert torch.equal(m.cuts, whole.cuts)
    for k in ("bins_t", "y_d", "w_d"):
        assert torch.equal(dc[k], dw[k]), k
    # with the cuts given no f32 row goes up whole
    m2 = HistGBT(n_bins=16)
    m2._missing = missing
    d2 = m2.make_device_data(X, y, weight=w, cuts=whole.cuts)
    assert torch.equal(d2["bins_t"], dw["bins_t"])
    # the JAX package's bins of the same rows
    j = JaxHistGBT(n_bins=16)
    dj = j.make_device_data(X, y, weight=w)
    np.testing.assert_array_equal(np.asarray(j.cuts), whole.cuts.numpy())
    np.testing.assert_array_equal(
        np.asarray(dj["bins_t"])[:, :len(y)], dc["bins_t"].numpy())


def test_chunked_eval_set_bins(monkeypatch):
    X, y = _data()
    Xv, _ = _data(n=300, seed=9)
    m = HistGBT(n_bins=16)
    m.make_device_data(X, y)
    monkeypatch.setenv("DMLC_INGEST_CHUNK_ROWS", "0")
    whole = m._bin_rows(Xv, 0, len(Xv))
    monkeypatch.setenv("DMLC_INGEST_CHUNK_ROWS", "64")
    assert torch.equal(m._bin_rows(Xv, 0, len(Xv)), whole)
    assert torch.equal(m._bin_rows(Xv, 37, 250), whole[:, 37:250])


_CHUNK_RANK = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from dmlc_core_tpu_torch.models import HistGBT
from dmlc_core_tpu_torch.parallel import collectives as coll
coll.init(backend="gloo")
d = sys.argv[1]
X = np.load(os.path.join(d, "X.npy"))
y = np.load(os.path.join(d, "y.npy"))
out = {}
for chunk in ("0", "7", "96"):
    os.environ["DMLC_INGEST_CHUNK_ROWS"] = chunk
    m = HistGBT(device="cpu", n_bins=16)
    dd = m.make_device_data(X, y)
    out[chunk] = {"bins": dd["bins_t"].numpy().tobytes().hex(),
                  "shape": list(dd["bins_t"].shape),
                  "rows": list(m.mesh.row_range(len(y))),
                  "cuts": m.cuts.numpy().tobytes().hex(),
                  "pending": m._pending_warmup is not None}
with open(os.path.join(d, f"r{coll.rank()}.json"), "w") as f:
    json.dump(out, f)
coll.barrier()
coll.finalize()
"""


@pytest.mark.parametrize("missing", [False, True], ids=["standard", "nan"])
def test_chunked_bins_on_two_gloo_ranks(tmp_path, missing):
    X, y = _data(n=301, nan=missing)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    (tmp_path / "rank.py").write_text(_CHUNK_RANK)
    run_ranks([sys.executable, str(tmp_path / "rank.py"), str(tmp_path)],
              2, 120, tmp_path, env={**os.environ, "PYTHONPATH": ROOT})
    one = HistGBT(n_bins=16)
    whole = one.make_device_data(X, y)["bins_t"].numpy()
    for r in range(2):
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        lo, hi = got["0"]["rows"]
        want = whole[:, lo:hi]
        for chunk in ("0", "7", "96"):
            g = got[chunk]
            assert g["rows"] == [lo, hi]
            assert g["cuts"] == one.cuts.numpy().tobytes().hex()
            assert bytes.fromhex(g["bins"]) == want.tobytes(), (r, chunk)
            # several ranks stay serial: no handle parks
            assert g["pending"] is False


# ---------------------------------------------------------------------------
# the cold-start handle
# ---------------------------------------------------------------------------

def test_overlap_on_and_off_write_one_file(monkeypatch, tmp_path):
    X, y = _data(seed=2)
    files = []
    for overlap in ("1", "0"):
        monkeypatch.setenv("DMLC_COLDSTART_OVERLAP", overlap)
        m = HistGBT(n_trees=4, max_depth=3, n_bins=16)
        dd = m.make_device_data(X, y)
        assert (m._pending_warmup is not None) == (overlap == "1")
        m.fit_device(dd, warmup_rounds=1)
        assert m._pending_warmup is None
        # the CPU builds nothing: no compile time is claimed
        assert m.last_compile_seconds is None
        assert m.last_compile_cache is None
        path = tmp_path / f"m{overlap}.json"
        m.save_model(str(path))
        files.append(path.read_bytes())
    assert files[0] == files[1]


class _Built:
    """A stand-in for a CUDA build handle on the CPU: done, with a
    build's time, counting its joins."""

    builds = True
    cache = "miss"
    seconds = 1.5

    def __init__(self):
        self.claimed = False
        self.joins = 0

    def join(self):
        self.joins += 1
        return 0.25


def test_handle_is_kept_and_claimed_once(monkeypatch):
    X, y = _data()
    m = HistGBT(n_trees=3, max_depth=3, n_bins=16)
    assert m.start_warmup(len(y), X.shape[1]) is False   # nothing to build
    parked = m._pending_warmup
    assert parked is not None and not parked[0].builds
    # one handle a process: every model parks the same one
    assert parked[0] is port_histgbt._WARMUPS["cpu"]
    m.make_device_data(X, y)
    assert m._pending_warmup is parked                   # kept
    m.make_device_data(X[:400], y[:400])
    assert m._pending_warmup is parked                   # kept, its key too
    assert parked[1] != m._warm_key(X.shape[1], 400)
    other = HistGBT(n_trees=2, max_depth=2, n_bins=8)
    other.make_device_data(X, y)
    assert other._pending_warmup[0] is parked[0]
    # a build's time goes to the first fit that joins it, and only when
    # the handle was parked for that fit
    built = _Built()
    monkeypatch.setattr(port_histgbt, "_process_warmup",
                        lambda *a: built)
    fits = []
    for n_trees in (3, 3):
        f = HistGBT(n_trees=n_trees, max_depth=3, n_bins=16)
        f.fit_device(f.make_device_data(X, y), warmup_rounds=1)
        fits.append(f)
    assert (fits[0].last_compile_seconds, fits[0].last_compile_cache) == \
        (1.5, "miss")
    assert fits[0].last_warmup_breakdown["trace"] == 0.25
    assert fits[1].last_compile_seconds is None          # ready already
    assert fits[1].last_compile_cache is None
    drift = _Built()
    monkeypatch.setattr(port_histgbt, "_process_warmup",
                        lambda *a: drift)
    f = HistGBT(n_trees=2, max_depth=3, n_bins=16)
    dd = f.make_device_data(X, y)
    f.param.n_trees = 3
    f.fit_device(dd, warmup_rounds=1)
    assert f.last_compile_seconds is None and drift.claimed
    assert (built.joins, drift.joins) == (2, 1)


def test_bin_pack_keeps_the_handle_parked_before_the_data(monkeypatch,
                                                         tmp_path):
    # a layout found after binning does not touch the handle that
    # start_warmup parked before the data existed: the kernels' build
    # does not depend on the layout
    monkeypatch.setenv("DMLC_BIN_PACK", "1")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    X[:, 2] = rng.integers(0, 3, 600).astype(np.float32)
    X[:, 5] = rng.integers(0, 4, 600).astype(np.float32)
    y = (X[:, 0] + X[:, 2] > 0.5).astype(np.float32)
    built = _Built()
    monkeypatch.setattr(port_histgbt, "_process_warmup", lambda *a: built)
    m = HistGBT(n_trees=3, max_depth=3, n_bins=16)
    assert m.start_warmup(len(y), X.shape[1]) is True
    parked = m._pending_warmup
    dd = m.make_device_data(X, y)
    assert dd["layout"] is not None
    assert m._pending_warmup is parked
    m.fit_device(dd, warmup_rounds=1)
    assert built.joins == 1 and m.last_compile_seconds == 1.5
    # the same trees as without the handle
    monkeypatch.setenv("DMLC_COLDSTART_OVERLAP", "0")
    ref = HistGBT(n_trees=3, max_depth=3, n_bins=16)
    ref.fit_device(ref.make_device_data(X, y), warmup_rounds=1)
    assert ref.last_compile_seconds is None
    for name, fit in (("m", m), ("ref", ref)):
        fit.save_model(str(tmp_path / f"{name}.json"))
    assert ((tmp_path / "m.json").read_bytes()
            == (tmp_path / "ref.json").read_bytes())


def test_failed_build_raises_at_the_join(monkeypatch, tmp_path):
    # no nvcc on this host: a CUDA handle's build fails on its thread,
    # the join raises it and drops the handle, so the next fit builds
    # again; nothing falls back
    from dmlc_core_tpu_torch.ops import _build

    def no_nvcc():
        _build.log_fatal("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(port_histgbt, "_WARMUPS", {})
    dev = torch.device("cuda")
    warm = port_histgbt._process_warmup(dev, 4, 16, 4)
    assert warm.builds and warm.cache == "miss"
    assert port_histgbt._process_warmup(dev, 4, 16, 4) is warm
    with pytest.raises(Error, match="nvcc not found"):
        warm.join()
    assert "cuda" not in port_histgbt._WARMUPS


def test_warmup_exec_knob_is_checked(monkeypatch):
    X, y = _data()
    monkeypatch.setenv("DMLC_WARMUP_EXEC", "2")
    with pytest.raises(Error, match="DMLC_WARMUP_EXEC"):
        HistGBT(n_trees=2, max_depth=2, n_bins=8).fit(X, y)
    for v in ("auto", "0", "1"):
        monkeypatch.setenv("DMLC_WARMUP_EXEC", v)
        m = HistGBT(n_trees=2, max_depth=2, n_bins=8).fit(X, y)
        assert len(m.trees) == 2


def test_fit_external_parks_its_handle(monkeypatch):
    X, y = _data(n=2000)
    m = HistGBT(n_trees=2, max_depth=3, n_bins=16)
    seen = []
    real = m._maybe_start_warmup

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(m, "_maybe_start_warmup", spy)
    m.fit_external(ArrayRowIter(X, y, page_rows=512))
    assert seen and seen[0][:2] == (X.shape[1], len(y))
    assert m._pending_warmup is None                     # joined


# ---------------------------------------------------------------------------
# the external engine's phase timings
# ---------------------------------------------------------------------------

def _external_chunked(monkeypatch, X, y, n_chunks, **kw):
    n, F = X.shape
    monkeypatch.setenv("DMLC_TPU_EXTERNAL_DEVICE_BUDGET",
                       str(n * 24 + F * (-(-n // n_chunks))))
    m = HistGBT(**kw)
    m.fit_external(ArrayRowIter(X, y, page_rows=256))
    assert m.last_external_route == "chunked"
    assert m.last_external_chunks == n_chunks
    return m


@pytest.mark.skipif(not _metrics.enabled(), reason="metrics disabled")
def test_phase_timings_observe_every_phase(monkeypatch, tmp_path):
    X, y = _data(n=1200, seed=6)
    kw = dict(n_trees=3, max_depth=3, n_bins=16)
    ph = gbt_metrics()["phase"]
    names = ("hist", "split", "leaf", "apply")

    def counts():
        return {p: ph.count(engine="external", phase=p) for p in names}

    waits = []
    real = port_histgbt.block_until_ready_time

    def spy(fn, *a, **k):
        waits.append(1)
        return real(fn, *a, **k)

    monkeypatch.setattr(port_histgbt, "block_until_ready_time", spy)
    before = counts()
    off = _external_chunked(monkeypatch, X, y, 4, **kw)
    assert counts() == before and not waits      # off: nothing waits
    monkeypatch.setenv("DMLC_METRICS_GBT_PHASES", "1")
    on = _external_chunked(monkeypatch, X, y, 4, **kw)
    got = {p: counts()[p] - before[p] for p in names}
    T, D, C = kw["n_trees"], kw["max_depth"], 4
    assert got == {"hist": T * D * C, "split": T * D, "leaf": T * C,
                   "apply": T * C}
    assert len(waits) == sum(got.values())
    for name, m in (("off", off), ("on", on)):
        m.save_model(str(tmp_path / f"{name}.json"))
    assert ((tmp_path / "off.json").read_bytes()
            == (tmp_path / "on.json").read_bytes())
